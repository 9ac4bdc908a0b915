// K1: DoG extremum candidate mask.
//
// Replaces: popsift_tpu/ops/pallas/extrema_mask.py:candidate_mask_canvas_pallas
// (and its dense and frame-batched siblings, which compute the same mask).
//
// What bounds it on the H100: memory. At octave 0 of a 1080p frame the
// DoG stack is 5 x 2160 x 3840 f32 (166 MB) and the mask 3 x 8.3 M bytes;
// the 26 comparisons per pixel are cheap next to that.
//
// What the design does about it: a block owns a 32 x 8 pixel tile and walks
// the layers z = 1 .. D-2 itself, keeping a ring of three layers (tile plus
// a one-pixel halo) in shared memory. Each DoG layer is read from device
// memory once per tile (plus the 1.3x halo) instead of the 27 reads of a
// naive stencil, and the threads of a warp read neighbouring addresses.
// Reads at the image edge are clamped (edge replication), which makes the
// outermost pixels false exactly as the edge-padded XLA twin does
// (popsift_tpu/ops/extrema.py:115-125); the kernel also forces them false.
//
// Semantics: out[z-1, y, x] = |c| >= thr1 and (c > all 26 neighbours or
// c < all 26 neighbours), c = dog[z, y, x].
//
// Frame-batched entry (replaces extrema_mask.py:candidate_mask_canvas_batched):
// F frames' D-layer stacks lie back to back, f32[F*D, H, W]; grid z is the
// frame, and a block's base pointers move to its frame's first layer and
// first mask layer, so the ring and the clamped reads never leave the
// frame's own D layers. Output u8[F, D-2, H, W], one launch per octave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(TX * TY)
extrema_mask_kernel(const float* __restrict__ dog, uint8_t* __restrict__ out,
                    int D, int H, int W, float thr1) {
    __shared__ float tile[3][TY + 2][TX + 2];
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int bx = blockIdx.x * TX;
    const int by = blockIdx.y * TY;
    const int x = bx + tx;
    const int y = by + ty;
    const size_t plane = (size_t)H * (size_t)W;
    const int tid = ty * TX + tx;
    dog += (size_t)blockIdx.z * (size_t)D * plane;
    out += (size_t)blockIdx.z * (size_t)(D - 2) * plane;

    auto load = [&](int layer) {
        float (*dst)[TX + 2] = tile[layer % 3];
        const float* src = dog + (size_t)layer * plane;
        for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
            const int r = i / (TX + 2);
            const int c = i - r * (TX + 2);
            const int gy = clampi(by + r - 1, 0, H - 1);
            const int gx = clampi(bx + c - 1, 0, W - 1);
            dst[r][c] = src[(size_t)gy * W + gx];
        }
    };

    load(0);
    load(1);
    const bool inside = x < W && y < H;
    const bool border = x == 0 || y == 0 || x >= W - 1 || y >= H - 1;
    for (int z = 1; z <= D - 2; ++z) {
        load(z + 1);   // slot (z+1)%3 was last read in iteration z-2
        __syncthreads();
        const float c = tile[z % 3][ty + 1][tx + 1];
        bool gt = true;
        bool lt = true;
#pragma unroll
        for (int dz = -1; dz <= 1; ++dz) {
            const float (*t)[TX + 2] = tile[(z + dz) % 3];
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
                for (int dx = -1; dx <= 1; ++dx) {
                    if (dz == 0 && dy == 0 && dx == 0) continue;
                    const float nb = t[ty + 1 + dy][tx + 1 + dx];
                    gt = gt && (c > nb);
                    lt = lt && (c < nb);
                }
            }
        }
        if (inside) {
            const bool m = !border && fabsf(c) >= thr1 && (gt || lt);
            out[(size_t)(z - 1) * plane + (size_t)y * W + x] = m ? 1 : 0;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int ps_extrema_mask_batched(const float* dog, uint8_t* out, int F,
                                       int D, int H, int W, float thr1,
                                       void* stream) {
    if (F < 1 || F > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(TX, TY);
    const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, F);
    extrema_mask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        dog, out, D, H, W, thr1);
    return (int)cudaGetLastError();
}

extern "C" int ps_extrema_mask(const float* dog, uint8_t* out, int D, int H,
                               int W, float thr1, void* stream) {
    return ps_extrema_mask_batched(dog, out, 1, D, H, W, thr1, stream);
}
