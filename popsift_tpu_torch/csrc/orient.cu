// K3: raw 36-bin orientation histograms.
//
// Replaces: popsift_tpu/ops/pallas/orient.py:orientation_hist_pallas.
//
// What bounds it on the H100: arithmetic and the scattered bin updates, not
// bytes. A keypoint's window is at most 47 x 47 pixels of one blur level
// (r = round(4.5 sigma) <= 23), a few KB that L1/L2 serve; per pixel the
// work is a gradient, sqrtf, atan2f and expf.
//
// What the design does about it: one block of 128 threads per keypoint row,
// the threads striding over the keypoint's own (2r+1)^2 window (the TPU
// kernel scanned a static 56 x 128 patch for every row). Each thread keeps
// its partial histogram in its own row of shared memory, so there are no
// atomics; the 128 partial histograms are then summed by a fixed binary tree.
// Two runs give the same bits.
//
// Semantics: popsift_tpu/ops/orientation.py:_orientation_hist_xla (:52-110)
// and s_orientation.cu:96-134. Rounding is round-half-to-even (rintf), as
// jnp.round; the build uses -fmad=false so d^2 is rounded as in the JAX
// code before its floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NBINS = 36;
constexpr float PI_F = 3.14159265358979323846f;        // np.float32(pi)
constexpr float TWO_PI_F = 6.28318530717958647692f;    // np.float32(2 pi)

__global__ void __launch_bounds__(NT)
orientation_hist_kernel(const float* __restrict__ blur, int L, int H, int W,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys,
                        const float* __restrict__ sigmas,
                        const int* __restrict__ levels,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out) {
    __shared__ float part[NT][NBINS + 1];
    const int k = blockIdx.x;
    const int t = threadIdx.x;
    for (int b = 0; b < NBINS; ++b) part[t][b] = 0.f;

    if (valid[k]) {   // uniform across the block
        const float x = xs[k];
        const float y = ys[k];
        const float sigma = sigmas[k];
        int lv = levels[k];
        lv = lv < 0 ? 0 : (lv > L - 1 ? L - 1 : lv);
        const float* img = blur + (size_t)lv * H * W;
        const int xr = __float2int_rn(x);
        const int yr = __float2int_rn(y);
        const float sigw = 1.5f * sigma;
        const int rad = __float2int_rn(3.0f * sigw);
        const float factor = -0.5f / (sigw * sigw + 1e-30f);
        const float sq_thres = (float)(rad * rad);
        const int side = 2 * rad + 1;
        const int npix = side * side;
        for (int p = t; p < npix; p += NT) {
            const int yy = yr - rad + p / side;
            const int xx = xr - rad + p % side;
            if (xx < 1 || xx > W - 2 || yy < 1 || yy > H - 2) continue;
            const float fdx = (float)xx - x;
            const float fdy = (float)yy - y;
            const float sq = floorf(fdx * fdx + fdy * fdy);
            if (!(sq <= sq_thres)) continue;
            const float* row = img + (size_t)yy * W;
            const float gx = row[xx + 1] - row[xx - 1];
            const float gy = row[xx + W] - row[xx - W];
            const float grad = sqrtf(gx * gx + gy * gy);
            const float theta = atan2f(gy, gx);
            const float w = grad * expf(sq * factor);
            int bin = __float2int_rn(36.0f * (theta + PI_F) / TWO_PI_F);
            if (bin == NBINS) bin = 0;
            part[t][bin] += w;
        }
    }
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
        if (t < s) {
            for (int b = 0; b < NBINS; ++b) part[t][b] += part[t + s][b];
        }
        __syncthreads();
    }
    if (t < NBINS) out[(size_t)k * NBINS + t] = part[0][t];
}

}  // namespace

extern "C" int ps_orientation_hist(const float* blur, int L, int H, int W,
                                   const float* x, const float* y,
                                   const float* sigma, const int* level,
                                   const uint8_t* valid, int n, float* out,
                                   void* stream) {
    orientation_hist_kernel<<<n, NT, 0, (cudaStream_t)stream>>>(
        blur, L, H, W, x, y, sigma, level, valid, out);
    return (int)cudaGetLastError();
}
