// K4: loop-variant SIFT descriptors.
//
// Replaces: popsift_tpu/ops/pallas/desc.py:descriptor_loop_pallas_dma (the
// in-kernel window DMA form of the loop descriptor).
//
// What bounds it on the H100: arithmetic. This is the hottest stage of the
// pipeline: every pixel of a job's window costs a gradient, sqrtf, atan2f,
// expf, a rotation and eight tile weights, and each pixel's term then feeds
// 128 output bins. The window (a few thousand pixels of one blur level) is
// small and cached; device-memory bytes are not the limit.
//
// What the design does about it: one block of 128 threads per job, one
// thread per output bin (ty, tx, b). The job's window is walked in chunks of
// CH pixels: first the threads compute each pixel's terms (tile weights
// wx[4], wy[4], the two angle-bin weights and the lower bin) into shared
// memory, then every thread adds the chunk's contributions to its own bin in
// pixel order. No atomics, fixed order: two runs give the same bits.
//
// The window. The JAX twin (popsift_tpu/ops/descriptors.py:392-473) scans a
// static (2R+1)^2 window, R = loop_patch_radius, whose origin is
// clip(round(p) - R, 0, max(n, 2R+1) - (2R+1)) per axis. Only pixels with
// max(|nx|, |ny|) < 2.5 get a non-zero tile weight, i.e. pixels within
// 2.5 sqrt(2) SBP of the keypoint (SBP = 3 sigma), so this kernel scans only
// the job's own support, s = ceil(2.5 sqrt(2) SBP) + 2 around the rounded
// keypoint (the +2 covers the rounding of the centre), intersected with the
// static window: pixels outside the support add exactly zero, so the sum is
// unchanged, and most jobs (small sigma) scan a small fraction of the static
// window. The intersection matters for the rare keypoints with
// s > R (sn > maxlevel - 0.5): there the static window truncates the support
// and the twin's circular-roll gradient wraps at the window border; the
// kernel reproduces both (ROADMAP section C records this quirk).
//
// Angles: tha = theta - ang folded into [0, 2 pi), tth = tha * 4/pi,
// fo = floor(tth) taken modulo 8 with non-negative operands (C's % keeps the
// dividend's sign, jnp.mod the divisor's).
//
// Patch entry (replaces popsift_tpu/ops/pallas/desc.py:descriptor_loop_pallas,
// the Pallas call at :174): the same block and bin layout on pre-cut windows,
// f32[F, P, PL] with origins (y0, x0): cell (i, j) of job k is the pixel
// (y0[k] + i, x0[k] + j). The gradient is the central difference inside the
// patch with zeros beyond its edge (desc.py:92-97), where the stack entry
// wraps; both agree wherever the bounds test 1 <= px <= W-2, 1 <= py <= H-2
// passes and the support lies inside the window. atan2f is the native one
// (the TPU kernel's polynomial stood in for a missing primitive).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads = output bins (4 x 4 tiles x 8 angles)
constexpr int CH = 256;    // pixels staged per chunk
constexpr float TWO_PI_F = 6.28318530717958647692f;      // np.float32(2 pi)
constexpr float FOUR_OVER_PI_F = 1.27323954473516268615f;  // np.float32(4/pi)
constexpr float SUPPORT_F = 3.53553390593273762200f;     // 2.5 sqrt(2)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// PATCH = false: `src` is the blur stack f32[L, H, W], the window is the
// twin's static (2R+1)^2 one (P = PL = 2R + 1). PATCH = true: `src` is the
// patch array f32[F, P, PL] with origins (y0s, x0s); levels and R are unused.
template <bool PATCH>
__global__ void __launch_bounds__(NT)
descriptor_loop_kernel(const float* __restrict__ src, int L, int H, int W,
                       const float* __restrict__ xs,
                       const float* __restrict__ ys,
                       const float* __restrict__ sigmas,
                       const int* __restrict__ levels,
                       const float* __restrict__ angs,
                       const uint8_t* __restrict__ valid, int R,
                       const int* __restrict__ y0s,
                       const int* __restrict__ x0s, int P, int PL,
                       float* __restrict__ out) {
    __shared__ float s_wx[CH][4];
    __shared__ float s_wy[CH][4];
    __shared__ float s_c0[CH];
    __shared__ float s_c1[CH];
    __shared__ int s_fo[CH];

    const int k = blockIdx.x;
    const int t = threadIdx.x;
    const float x = xs[k];
    const float y = ys[k];
    const float ang = angs[k];
    const float sbp = fabsf(3.0f * sigmas[k]);
    if (!valid[k] || sbp == 0.0f) {   // uniform across the block
        out[(size_t)k * NT + t] = 0.f;
        return;
    }
    const float inv_sbp = 1.0f / sbp;
    const float crsbp = cosf(ang) * inv_sbp;
    const float srsbp = sinf(ang) * inv_sbp;
    const int xr = __float2int_rn(x);
    const int yr = __float2int_rn(y);
    const float* img;
    int py0, px0;
    if (PATCH) {
        // the job's own pre-cut window: origin (py0, px0), P rows x PL cols
        img = src + (size_t)k * P * PL;
        py0 = y0s[k];
        px0 = x0s[k];
    } else {
        // static window of the twin: origin (py0, px0), side P = PL
        const int lv = clampi(levels[k], 0, L - 1);
        img = src + (size_t)lv * H * W;
        P = PL = 2 * R + 1;
        py0 = clampi(yr - R, 0, max(H, P) - P);
        px0 = clampi(xr - R, 0, max(W, P) - P);
    }
    // the job's support, intersected with the window and with the scan
    // bounds [1, W-2] x [1, H-2]; (i, j) are window-local coordinates
    const int s = (int)ceilf(SUPPORT_F * sbp) + 2;
    const int i_lo = max(max(0, yr - s - py0), 1 - py0);
    const int i_hi = min(min(P - 1, yr + s - py0), H - 2 - py0);
    const int j_lo = max(max(0, xr - s - px0), 1 - px0);
    const int j_hi = min(min(PL - 1, xr + s - px0), W - 2 - px0);
    const int ncol = j_hi - j_lo + 1;
    const int npix = (i_hi >= i_lo && ncol > 0) ? (i_hi - i_lo + 1) * ncol : 0;

    const int ty = t >> 5;
    const int tx = (t >> 3) & 3;
    const int b = t & 7;
    float acc = 0.f;

    for (int base = 0; base < npix; base += CH) {
        for (int q = t; q < CH; q += NT) {
            const int p = base + q;
            float wx[4] = {0.f, 0.f, 0.f, 0.f};
            float wy[4] = {0.f, 0.f, 0.f, 0.f};
            float c0 = 0.f, c1 = 0.f;
            int fo0 = 0;
            if (p < npix) {
                const int i = i_lo + p / ncol;
                const int j = j_lo + p - (p / ncol) * ncol;
                const int yy = py0 + i;
                const int xx = px0 + j;
                float gx, gy;
                if (PATCH) {
                    // patch cell (i, j); zeros beyond the patch edge
                    const float* row = img + (size_t)i * PL;
                    gx = (j + 1 < PL ? row[j + 1] : 0.f)
                       - (j > 0 ? row[j - 1] : 0.f);
                    gy = (i + 1 < P ? row[j + PL] : 0.f)
                       - (i > 0 ? row[j - PL] : 0.f);
                } else {
                    // window cell (ii, jj) holds img[min(py0+ii, H-1),
                    // min(px0+jj, W-1)]; neighbours wrap inside the window
                    const int ju = (j + 1 == P) ? 0 : j + 1;
                    const int jd = (j == 0) ? P - 1 : j - 1;
                    const int iu = (i + 1 == P) ? 0 : i + 1;
                    const int id = (i == 0) ? P - 1 : i - 1;
                    const float* row = img + (size_t)min(yy, H - 1) * W;
                    gx = row[min(px0 + ju, W - 1)]
                       - row[min(px0 + jd, W - 1)];
                    gy = img[(size_t)min(py0 + iu, H - 1) * W
                             + min(xx, W - 1)]
                       - img[(size_t)min(py0 + id, H - 1) * W
                             + min(xx, W - 1)];
                }
                const float mod = sqrtf(gx * gx + gy * gy);
                const float th = atan2f(gy, gx);
                const float fdx = (float)xx - x;
                const float fdy = (float)yy - y;
                const float nxg = crsbp * fdx + srsbp * fdy;
                const float nyg = crsbp * fdy - srsbp * fdx;
                float tha = th - ang;
                if (tha < 0.0f) tha += TWO_PI_F;
                if (tha >= TWO_PI_F) tha -= TWO_PI_F;
                const float tth = tha * FOUR_OVER_PI_F;
                const float fof = floorf(tth);
                const float frac = tth - fof;
                const int fo = (int)fof;
                fo0 = ((fo % 8) + 8) % 8;
                const float ww = expf(-0.125f * (nxg * nxg + nyg * nyg));
                const float wgt = ww * mod;
                c0 = wgt * (1.0f - frac);
                c1 = wgt * frac;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float cent = (float)c - 1.5f;
                    const float ax = fabsf(nxg - cent);
                    const float ay = fabsf(nyg - cent);
                    wx[c] = ax < 1.0f ? 1.0f - ax : 0.0f;
                    wy[c] = ay < 1.0f ? 1.0f - ay : 0.0f;
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s_wx[q][c] = wx[c];
                s_wy[q][c] = wy[c];
            }
            s_c0[q] = c0;
            s_c1[q] = c1;
            s_fo[q] = fo0;
        }
        __syncthreads();
        const int lim = min(CH, npix - base);
        for (int q = 0; q < lim; ++q) {
            const int f0 = s_fo[q];
            const float cb = (b == f0) ? s_c0[q]
                           : ((b == ((f0 + 1) & 7)) ? s_c1[q] : 0.0f);
            acc += (s_wy[q][ty] * cb) * s_wx[q][tx];
        }
        __syncthreads();
    }
    out[(size_t)k * NT + t] = acc;   // t = ty * 32 + tx * 8 + b
}

}  // namespace

extern "C" int ps_descriptor_loop(const float* blur, int L, int H, int W,
                                  const float* x, const float* y,
                                  const float* sigma, const int* level,
                                  const float* ang, const uint8_t* valid,
                                  int n, int radius, float* out,
                                  void* stream) {
    descriptor_loop_kernel<false><<<n, NT, 0, (cudaStream_t)stream>>>(
        blur, L, H, W, x, y, sigma, level, ang, valid, radius, nullptr,
        nullptr, 0, 0, out);
    return (int)cudaGetLastError();
}

// patches f32[n.., P, PL]; y0, x0 i32: image coordinates of each patch's
// cell (0, 0); (H, W): the octave's dims for the scan-bounds test.
extern "C" int ps_descriptor_loop_patches(const float* patches, int P, int PL,
                                          int H, int W, const int* y0,
                                          const int* x0, const float* x,
                                          const float* y, const float* sigma,
                                          const float* ang,
                                          const uint8_t* valid, int n,
                                          float* out, void* stream) {
    if (P < 1 || PL < 1) return (int)cudaErrorInvalidValue;
    descriptor_loop_kernel<true><<<n, NT, 0, (cudaStream_t)stream>>>(
        patches, 0, H, W, x, y, sigma, nullptr, ang, valid, 0, y0, x0, P, PL,
        out);
    return (int)cudaGetLastError();
}
