// K5: fused separable Gaussian blur + DoG of one pyramid level.
//
// Replaces: popsift_tpu/ops/pallas/blur.py:blur_and_dog (the Pallas call at
// :102), which the JAX package ran once per (octave, level).
//
// What bounds it on the H100: memory and launches. The plain PyTorch form
// issues 2 + 2 (1 + 3S) elementwise kernels per level (about 2500 per 1080p
// frame) and streams an [H, W] plane through device memory for each. Fused,
// one level reads blur_{l-1} once and writes blur_l and DoG_{l-1} once: 12
// bytes a pixel, about 0.66 GB per 1080p frame over all octaves. The taps
// (2S + 1 <= 27 multiply-adds per pass) are cheap next to that.
//
// What the design does about it: one launch per level covers every plane of
// a [N, H, W] batch (grid z = plane), so the frame-batched front launches once
// per (octave, level) for all frames. A block owns a 32 x 32 output tile. It
// stages the tile plus an S-pixel halo in shared memory with clamped reads
// (edge replication, the reference's clamped texture, assist.h:66-81), runs
// the horizontal pass over all staged rows into a second shared buffer, then
// the vertical pass, and writes blur and blur - input. Planes may be strided
// (a level of a [N, L, H, W] stack), so the pyramid writes in place.
//
// Arithmetic follows popsift_tpu_torch/ops/kernels/blur_dog.py:_sep_blur, the
// JAX shift-and-add order: horizontal before vertical, the centre tap first,
// then acc = acc + (left + right) * tap[off] for off = 1..S, one rounding per
// operation (the library is built with -fmad=false). The DoG is a separate
// subtraction. So the kernel equals its plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;     // output tile columns (one warp)
constexpr int TH = 32;     // output tile rows
constexpr int BY = 8;      // thread rows of a block
constexpr int MAX_S = 24;  // widest half-filter taken

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Taps {
    float t[MAX_S + 1];    // t[0] centre, t[off] the pair at +-off
};

__global__ void __launch_bounds__(TW * BY)
blur_dog_kernel(const float* __restrict__ src, long long src_stride,
                float* __restrict__ blur, long long blur_stride,
                float* __restrict__ dog, long long dog_stride, int H, int W,
                int S, Taps taps) {
    extern __shared__ float smem[];
    __shared__ float tap[MAX_S + 1];
    const int IW = TW + 2 * S;       // staged input columns
    const int IH = TH + 2 * S;       // staged input rows
    float* in = smem;                // [IH][IW]
    float* hz = smem + IH * IW;      // [IH][TW] horizontal pass
    const int p = blockIdx.z;
    const float* s = src + (size_t)p * (size_t)src_stride;
    const int bx = blockIdx.x * TW;
    const int by = blockIdx.y * TH;
    const int tx = threadIdx.x;
    const int tid = threadIdx.y * TW + tx;

    if (tid <= S) tap[tid] = taps.t[tid];
    for (int i = tid; i < IH * IW; i += TW * BY) {
        const int r = i / IW;
        const int c = i - r * IW;
        const int gy = clampi(by - S + r, 0, H - 1);
        const int gx = clampi(bx - S + c, 0, W - 1);
        in[i] = s[(size_t)gy * W + gx];
    }
    __syncthreads();

    for (int r = threadIdx.y; r < IH; r += BY) {
        const float* row = in + r * IW + S + tx;
        float acc = row[0] * tap[0];
        for (int off = 1; off <= S; ++off)
            acc = acc + (row[-off] + row[off]) * tap[off];
        hz[r * TW + tx] = acc;
    }
    __syncthreads();

    const int x = bx + tx;
    for (int yy = threadIdx.y; yy < TH; yy += BY) {
        const int y = by + yy;
        const float* col = hz + (yy + S) * TW + tx;
        float acc = col[0] * tap[0];
        for (int off = 1; off <= S; ++off)
            acc = acc + (col[-off * TW] + col[off * TW]) * tap[off];
        if (x < W && y < H) {
            const size_t o = (size_t)y * W + x;
            blur[(size_t)p * (size_t)blur_stride + o] = acc;
            dog[(size_t)p * (size_t)dog_stride + o] =
                acc - in[(yy + S) * IW + S + tx];
        }
    }
}

}  // namespace

// src, blur, dog: N planes of H x W f32, each plane dense, planes
// `*_stride` floats apart. taps: host array of S + 1 floats.
extern "C" int ps_blur_dog(const float* src, long long src_stride,
                           float* blur, long long blur_stride, float* dog,
                           long long dog_stride, int N, int H, int W,
                           const float* taps, int S, void* stream) {
    if (S < 0 || S > MAX_S || N < 1 || H < 1 || W < 1 || N > 65535)
        return (int)cudaErrorInvalidValue;
    Taps t = {};
    for (int i = 0; i <= S; ++i) t.t[i] = taps[i];
    const size_t smem =
        sizeof(float) * (size_t)(TH + 2 * S) * (size_t)(TW + 2 * S + TW);
    const dim3 block(TW, BY);
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
    blur_dog_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        src, src_stride, blur, blur_stride, dog, dog_stride, H, W, S, t);
    return (int)cudaGetLastError();
}
