// K3: raw 36-bin orientation histograms.
//
// Replaces: popsift_tpu/ops/pallas/orient.py:orientation_hist_pallas.
//
// What bounds it on the H100: the latency of the per-pixel math (and past
// that the instruction rate), not bytes. A keypoint's window is at most
// 47 x 47 pixels of one blur level (r = round(4.5 sigma) <= 23), a few KB
// that L1/L2 serve; per pixel the work is a gradient, sqrtf, atan2f, expf
// and an IEEE division.
// A frame has a few thousand valid rows among tens of thousands of capacity
// rows, most of them in one octave.
//
// What the design does about it:
//  * One warp per keypoint row, four rows in flight a block. The lanes take
//    the pixels of the keypoint's own window, clipped to the scan bounds
//    [1, W-2] x [1, H-2], in a fixed stride (the TPU kernel scanned a static
//    56 x 128 patch for every row). Each lane adds into its own column of a
//    bin-major partial histogram in shared memory, [36][32] floats a warp:
//    bank = lane, so no conflict and no atomics. Lane b then sums bin b over
//    the 32 lanes in a fixed order (skewed by b, again one bank a lane).
//    `__syncwarp` only, no block barrier. The summation order is fixed by the
//    code and by the row alone: two runs, a single octave and all octaves, a
//    single frame and a batch give the same bits.
//  * One launch for all octaves and frames. The launch takes a by-value
//    table of per-octave (blur pointer, layers, H, W, end row) and walks
//    every row in a warp-stride loop; rows are F frames of `frame_rows` rows,
//    each frame's octave segments back to back, and frame f's level l is
//    layer f*L + l of its octave's stack. The kernel reads `valid` itself and
//    writes the zeros of the rows that are not valid, so the output needs no
//    fill and the host reads no count.
//
// Row bounds (a spatially sharded row band, popsift_tpu/parallel/spatial.py):
// each octave carries the global row of its stack's row 0, y_off, and
// inclusive global scan rows (y_lo, y_hi) in place of (1, H-2), JAX's
// _orientation_hist_xla(y_bounds=) (:52-65). Keypoints stay in global
// coordinates and only the reads move to the band, so a band whose halo
// holds every window gives the whole frame's bits (shifting the keypoints
// into the band instead would round their rows). The launch intersects the
// scan rows with the band's [y_off + 1, y_off + H - 2], so the gradient's
// reads never leave the stack. The defaults y_off = 0, (1, H-2) give the
// unbounded launch bit for bit.
//
// Semantics: popsift_tpu/ops/orientation.py:_orientation_hist_xla (:52-110)
// and s_orientation.cu:96-134. Rounding is round-half-to-even (rintf), as
// jnp.round; the build uses -fmad=false so d^2 is rounded as in the JAX
// code before its floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;
constexpr int NBINS = 36;
constexpr int MAX_OCT = 16;     // octaves one launch takes
// Blocks a launch: enough that a frame's rows take a warp each. A valid row
// is one warp's chain of dependent math, so spreading the rows wins (2112,
// 4224, 8448, 18432 blocks: 30.9, 26.4, 25.3, 24.7 us on a 1080p frame).
constexpr int MAX_GRID = 16384;
constexpr float PI_F = 3.14159265358979323846f;        // np.float32(pi)
constexpr float TWO_PI_F = 6.28318530717958647692f;    // np.float32(2 pi)

struct OctaveTable {
    const float* blur[MAX_OCT];  // f32[F*L, H, W]
    int L[MAX_OCT];
    int H[MAX_OCT];
    int W[MAX_OCT];
    int row_end[MAX_OCT];        // a frame's rows [row_end[o-1], row_end[o]) are octave o's
    int y_off[MAX_OCT];          // global row of the stack's row 0
    int y_lo[MAX_OCT];           // inclusive global scan rows, within the
    int y_hi[MAX_OCT];           // stack's [y_off + 1, y_off + H - 2]
    int n;
};

// q / d for 0 <= q, q * d < 2^21, with inv = 1.0f / d: the quotient's
// fraction is at least 0.5 / d away from an integer, the product's error
// far below that.
__device__ __forceinline__ int div_small(int q, float inv) {
    return (int)(((float)q + 0.5f) * inv);
}

__global__ void __launch_bounds__(NT)
orientation_hist_kernel(OctaveTable tab, int n_rows, int frame_rows,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ sigmas,
                        const long long* __restrict__ levels,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out) {
    __shared__ float part[WARPS][NBINS * 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float* mine = part[warp] + lane;

    for (int k = blockIdx.x * WARPS + warp; k < n_rows;
         k += gridDim.x * WARPS) {
        float* dst = out + (size_t)k * NBINS;
        if (!valid[k]) {          // uniform across the warp
            for (int b = lane; b < NBINS; b += 32) dst[b] = 0.f;
            continue;
        }
        const int f = k / frame_rows;
        const int kl = k - f * frame_rows;
        int o = 0;
        while (o + 1 < tab.n && kl >= tab.row_end[o]) ++o;
        const int L = tab.L[o], H = tab.H[o], W = tab.W[o];
        const float x = xs[k];
        const float y = ys[k];
        const float sigma = sigmas[k];
        const long long lv = levels[k];
        const int layer = f * L + (lv < 0 ? 0 : (lv > L - 1 ? L - 1 : (int)lv));
        const float* img = tab.blur[o] + (size_t)layer * H * W;
        const int y_off = tab.y_off[o];    // rows below are global
        const int xr = __float2int_rn(x);
        const int yr = __float2int_rn(y);
        const float sigw = 1.5f * sigma;
        const int rad = __float2int_rn(3.0f * sigw);
        const float factor = -0.5f / (sigw * sigw + 1e-30f);
        const float sq_thres = (float)(rad * rad);
        // the window clipped to the scan bounds
        const int x_lo = max(xr - rad, 1), x_hi = min(xr + rad, W - 2);
        const int y_lo = max(yr - rad, tab.y_lo[o]);
        const int y_hi = min(yr + rad, tab.y_hi[o]);
        const int bw = x_hi - x_lo + 1;
        const int npix = (bw > 0 && y_hi >= y_lo) ? bw * (y_hi - y_lo + 1) : 0;
        const float inv_bw = bw > 0 ? 1.0f / (float)bw : 0.0f;

#pragma unroll
        for (int b = 0; b < NBINS; ++b) mine[b * 32] = 0.f;
        for (int p = lane; p < npix; p += 32) {
            const int ri = div_small(p, inv_bw);
            const int yy = y_lo + ri;
            const int xx = x_lo + p - ri * bw;
            const float fdx = (float)xx - x;
            const float fdy = (float)yy - y;
            const float sq = floorf(fdx * fdx + fdy * fdy);
            if (!(sq <= sq_thres)) continue;
            const float* row = img + (size_t)(yy - y_off) * W;
            const float gx = row[xx + 1] - row[xx - 1];
            const float gy = row[xx + W] - row[xx - W];
            const float grad = sqrtf(gx * gx + gy * gy);
            const float theta = atan2f(gy, gx);
            const float w = grad * expf(sq * factor);
            int bin = __float2int_rn(36.0f * (theta + PI_F) / TWO_PI_F);
            if (bin == NBINS) bin = 0;
            mine[bin * 32] += w;
        }
        __syncwarp();
        for (int b = lane; b < NBINS; b += 32) {
            const float* bin = part[warp] + b * 32;
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < 32; ++j) s += bin[(j + b) & 31];
            dst[b] = s;
        }
        __syncwarp();
    }
}

}  // namespace

// One launch over n_rows keypoint rows: F = n_rows / frame_rows frames of
// frame_rows rows each. `table` is a host array i64[n_oct, 8]: blur stack
// address (f32[F*L, H, W]), L, H, W, the end of the octave's rows within a
// frame (ascending; the last is frame_rows), the global row of the stack's
// row 0 and the inclusive global scan rows (y_lo, y_hi): 0, 1 and H-2 for a
// whole octave. `level` is i64, `valid` one byte a row (0 or 1); `out`
// f32[n_rows, 36] is written for every row.
extern "C" int ps_orientation_hist_octaves(const long long* table, int n_oct,
                                           int n_rows, int frame_rows,
                                           const float* x, const float* y,
                                           const float* sigma,
                                           const long long* level,
                                           const uint8_t* valid, float* out,
                                           void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT || n_rows < 1 || frame_rows < 1
        || n_rows % frame_rows != 0)
        return (int)cudaErrorInvalidValue;
    OctaveTable tab = {};
    tab.n = n_oct;
    for (int o = 0; o < n_oct; ++o) {
        const long long* r = table + 8 * o;
        for (int c = 5; c < 8; ++c)
            if (r[c] < -0x40000000LL || r[c] > 0x40000000LL)
                return (int)cudaErrorInvalidValue;
        tab.blur[o] = (const float*)(uintptr_t)r[0];
        tab.L[o] = (int)r[1];
        tab.H[o] = (int)r[2];
        tab.W[o] = (int)r[3];
        tab.row_end[o] = (int)r[4];
        tab.y_off[o] = (int)r[5];
        tab.y_lo[o] = (int)(r[6] > r[5] + 1 ? r[6] : r[5] + 1);
        tab.y_hi[o] = (int)(r[7] < r[5] + r[2] - 2 ? r[7] : r[5] + r[2] - 2);
    }
    const int blocks = (n_rows + WARPS - 1) / WARPS;
    const int grid = blocks < MAX_GRID ? blocks : MAX_GRID;
    orientation_hist_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        tab, n_rows, frame_rows, x, y, sigma, level, valid, out);
    return (int)cudaGetLastError();
}
