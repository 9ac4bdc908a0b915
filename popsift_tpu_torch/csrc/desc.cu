// K4: loop-variant SIFT descriptors.
//
// Replaces: popsift_tpu/ops/pallas/desc.py:descriptor_loop_pallas_dma (the
// in-kernel window DMA form of the loop descriptor) and, through the patch
// entry, descriptor_loop_pallas.
//
// What bounds it on the H100: instruction issue and latency, not bytes. A
// job's window is a few thousand pixels of one cached blur level; every
// pixel of its support costs a gradient, sqrtf, atan2f, expf and a rotation,
// and then feeds 2 x 2 tiles x 2 angle bins of the 128 outputs. A frame has
// a few thousand jobs, most of them in one octave and a handful in each of
// the others.
//
// What the design does about it:
//  * Gather by tile. A block of 512 threads takes a job, one warp per tile
//    (ty, tx). A pixel reaches tile (ty, tx) only if |nx - (tx - 1.5)| < 1
//    and |ny - (ty - 1.5)| < 1 in the job's rotated, 1/SBP-scaled frame,
//    i.e. inside a rotated square of half-side SBP around the tile centre
//    kp + SBP R(ang) (tx - 1.5, ty - 1.5). The warp walks the axis-aligned
//    box around that square, half-side SBP (|cos| + |sin|) + 1, clipped to
//    the job's scan bounds: at most about 8 SBP^2 pixels, where a thread of
//    the one-thread-per-bin form walked all 50 SBP^2. Lanes take the box's
//    pixels in a fixed stride and add (wy[ty] * cb) * wx[tx] into 8 bins
//    held in registers (predicated selects, no dynamic index); a fixed
//    xor-shuffle tree ends each bin. No atomics, no barrier in the tile
//    loop, a summation order fixed by the code: two runs, a single frame
//    and a batch, and every route give the same bits.
//  * Pixel terms once per pixel. The block stages (nx, ny, c0, c1, fo) of a
//    band of the support's rows in shared memory (20 bytes a pixel, bands of
//    at most CAP pixels), gradient, atan2f and expf only for pixels inside
//    the rotated 5 SBP x 5 SBP support; the tile warps read them. Two
//    barriers a band, and most jobs are one or two bands.
//  * One launch for all octaves. The launch takes a by-value table of
//    per-octave (blur pointer, layers, H, W, end row) and walks every row of
//    the frame's (or batch's) job list in a block-stride loop; a row that is
//    not valid costs one byte load. The thin octaves' few jobs run beside
//    the dense octave's thousands, and the host reads no count back.
//
// The window. The JAX twin (popsift_tpu/ops/descriptors.py:392-473) scans a
// static (2R+1)^2 window, R = loop_patch_radius, whose origin is
// clip(round(p) - R, 0, max(n, 2R+1) - (2R+1)) per axis. Only pixels with
// max(|nx|, |ny|) < 2.5 get a non-zero tile weight, i.e. pixels within
// 2.5 sqrt(2) SBP of the keypoint (SBP = 3 sigma), so the kernel scans only
// the job's own support, s = ceil(2.5 sqrt(2) SBP) + 2 around the rounded
// keypoint (the +2 covers the rounding of the centre), intersected with the
// static window and with [1, W-2] x [1, H-2]: pixels outside add exactly
// zero. The intersection matters for the rare keypoints with s > R
// (sn > maxlevel - 0.5): there the static window truncates the support and
// the twin's circular-roll gradient wraps at the window border; the kernel
// reproduces both (ROADMAP section C records this quirk).
//
// Row bounds (a spatially sharded row band, popsift_tpu/parallel/spatial.py):
// each octave of the all-octave entry carries the global row of its stack's
// row 0, y_off, and inclusive global scan rows (y_lo, y_hi) in place of
// (1, H-2), in the scan bound only; the static window's origin stays local
// to the stack. This is the twin's _descriptor_loop_chunk(y_bounds=)
// (descriptors.py:430-436) with the keypoints left in global coordinates
// (only the reads move to the band, so no keypoint row is rounded by a
// shift). Every read goes through the window, so any bounds are safe. The
// defaults y_off = 0, (1, H-2) give the unbounded launch bit for bit; the
// single-octave and patch entries always take them.
//
// Per-pixel arithmetic is the twin's, operation for operation (the library
// is built with -fmad=false): tha = theta - ang folded into [0, 2 pi),
// tth = tha * 4/pi, fo = floor(tth) taken modulo 8 with non-negative
// operands (C's % keeps the dividend's sign, jnp.mod the divisor's).
//
// Patch entry (replaces popsift_tpu/ops/pallas/desc.py:descriptor_loop_pallas,
// the Pallas call at :174): the same kernel on pre-cut windows,
// f32[F, P, PL] with origins (y0, x0): cell (i, j) of job k is the pixel
// (y0[k] + i, x0[k] + j). The gradient is the central difference inside the
// patch with zeros beyond its edge (desc.py:92-97), where the stack entry
// wraps; both agree wherever the bounds test 1 <= px <= W-2, 1 <= py <= H-2
// passes and the support lies inside the window. atan2f is the native one
// (the TPU kernel's polynomial stood in for a missing primitive).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;       // 16 warps = 4 x 4 tiles
constexpr int CAP = 2048;     // pixels staged per band
constexpr int MAX_OCT = 16;   // octaves one launch takes
constexpr int MAX_GRID = 2112;  // 16 blocks for each of the card's 132 SMs
constexpr float TWO_PI_F = 6.28318530717958647692f;      // np.float32(2 pi)
constexpr float FOUR_OVER_PI_F = 1.27323954473516268615f;  // np.float32(4/pi)
constexpr float SUPPORT_F = 3.53553390593273762200f;     // 2.5 sqrt(2)

struct OctaveTable {
    const float* src[MAX_OCT];   // blur stack f32[L, H, W] (or the patches)
    int L[MAX_OCT];
    int H[MAX_OCT];
    int W[MAX_OCT];
    int row_end[MAX_OCT];        // rows [row_end[o-1], row_end[o]) are octave o's
    int y_off[MAX_OCT];          // global row of the stack's row 0
    int y_lo[MAX_OCT];           // inclusive global scan rows
    int y_hi[MAX_OCT];
    int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// q / d for 0 <= q, q * d < 2^21, with inv = 1.0f / d: the quotient's
// fraction is at least 0.5 / d away from an integer, the product's error
// far below that.
__device__ __forceinline__ int div_small(int q, float inv) {
    return (int)(((float)q + 0.5f) * inv);
}

// One job's window: cell (i, j) is pixel (py0 + i, px0 + j) of the level,
// global row y_off + py0 + i.
struct Job {
    const float* img;
    int H, W, P, PL, py0, px0, y_off;
    float x, y, ang, crsbp, srsbp;
};

// The terms of window cell (i, j): its coordinates in the job's rotated,
// 1/SBP-scaled frame, the two angle-bin weights and the lower bin. Gradient,
// atan2f and expf only where a tile weight can be non-zero, |n| < 2.5 (the
// subtraction n - centre is exact there); elsewhere c0 = c1 = 0.
template <bool PATCH>
__device__ __forceinline__ void pixel_terms(const Job& jb, int i, int j,
                                            float& nxg, float& nyg, float& c0,
                                            float& c1, int& fo0) {
    const int yy = jb.py0 + i;
    const int xx = jb.px0 + j;
    const float fdx = (float)xx - jb.x;
    const float fdy = (float)(yy + jb.y_off) - jb.y;
    nxg = jb.crsbp * fdx + jb.srsbp * fdy;
    nyg = jb.crsbp * fdy - jb.srsbp * fdx;
    c0 = 0.f;
    c1 = 0.f;
    fo0 = 0;
    if (!(fabsf(nxg) < 2.5f && fabsf(nyg) < 2.5f)) return;
    const int H = jb.H, W = jb.W, P = jb.P, PL = jb.PL;
    float gx, gy;
    if (PATCH) {
        // patch cell (i, j); zeros beyond the patch edge
        const float* row = jb.img + (size_t)i * PL;
        gx = (j + 1 < PL ? row[j + 1] : 0.f) - (j > 0 ? row[j - 1] : 0.f);
        gy = (i + 1 < P ? row[j + PL] : 0.f) - (i > 0 ? row[j - PL] : 0.f);
    } else {
        // window cell (ii, jj) holds img[min(py0+ii, H-1), min(px0+jj, W-1)];
        // neighbours wrap inside the window
        const int ju = (j + 1 == P) ? 0 : j + 1;
        const int jd = (j == 0) ? P - 1 : j - 1;
        const int iu = (i + 1 == P) ? 0 : i + 1;
        const int id = (i == 0) ? P - 1 : i - 1;
        const float* row = jb.img + (size_t)min(yy, H - 1) * W;
        gx = row[min(jb.px0 + ju, W - 1)] - row[min(jb.px0 + jd, W - 1)];
        gy = jb.img[(size_t)min(jb.py0 + iu, H - 1) * W + min(xx, W - 1)]
           - jb.img[(size_t)min(jb.py0 + id, H - 1) * W + min(xx, W - 1)];
    }
    const float mod = sqrtf(gx * gx + gy * gy);
    const float th = atan2f(gy, gx);
    float tha = th - jb.ang;
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
}

// PATCH = false: `src` is the blur stack f32[L, H, W], the window is the
// twin's static (2R+1)^2 one (P = PL = 2R + 1). PATCH = true: `src` is the
// patch array f32[F, P, PL] with origins (y0s, x0s); levels and R are unused.
template <bool PATCH>
__global__ void __launch_bounds__(NT)
descriptor_loop_kernel(OctaveTable tab, int n_rows,
                       const float* __restrict__ xs,
                       const float* __restrict__ ys,
                       const float* __restrict__ sigmas,
                       const int* __restrict__ levels,
                       const float* __restrict__ angs,
                       const uint8_t* __restrict__ valid, int R,
                       const int* __restrict__ y0s,
                       const int* __restrict__ x0s, int P, int PL,
                       float* __restrict__ out) {
    __shared__ float s_nx[CAP];
    __shared__ float s_ny[CAP];
    __shared__ float s_c0[CAP];
    __shared__ float s_c1[CAP];
    __shared__ int s_fo[CAP];

    const int t = threadIdx.x;
    const int lane = t & 31;
    const int tile = t >> 5;            // ty * 4 + tx
    const float cent_x = (float)(tile & 3) - 1.5f;
    const float cent_y = (float)(tile >> 2) - 1.5f;

    for (int k = blockIdx.x; k < n_rows; k += gridDim.x) {
        if (!valid[k]) continue;        // uniform across the block
        const float sbp = fabsf(3.0f * sigmas[k]);
        if (sbp == 0.0f) continue;
        int o = 0;
        while (o + 1 < tab.n && k >= tab.row_end[o]) ++o;
        const int H = tab.H[o];
        const int W = tab.W[o];
        const float x = xs[k];
        const float y = ys[k];
        const float ang = angs[k];
        const float inv_sbp = 1.0f / sbp;
        const float ca = cosf(ang);
        const float sa = sinf(ang);
        const float crsbp = ca * inv_sbp;
        const float srsbp = sa * inv_sbp;
        const int xr = __float2int_rn(x);
        const int y_off = tab.y_off[o];
        const int yr = __float2int_rn(y) - y_off;   // the stack's row
        const float* img;
        int py0, px0;
        if (PATCH) {
            // the job's own pre-cut window: origin (py0, px0), P rows x PL cols
            img = tab.src[o] + (size_t)k * P * PL;
            py0 = y0s[k];
            px0 = x0s[k];
        } else {
            // static window of the twin: origin (py0, px0), side P = PL
            const int lv = clampi(levels[k], 0, tab.L[o] - 1);
            img = tab.src[o] + (size_t)lv * H * W;
            P = PL = 2 * R + 1;
            py0 = clampi(yr - R, 0, max(H, P) - P);
            px0 = clampi(xr - R, 0, max(W, P) - P);
        }
        // the job's support, intersected with the window and with the scan
        // bounds [1, W-2] x [y_lo, y_hi]; (i, j) are window-local coordinates
        const int s = (int)ceilf(SUPPORT_F * sbp) + 2;
        const int i_lo = max(max(0, yr - s - py0), tab.y_lo[o] - y_off - py0);
        const int i_hi = min(min(P - 1, yr + s - py0),
                             tab.y_hi[o] - y_off - py0);
        const int j_lo = max(max(0, xr - s - px0), 1 - px0);
        const int j_hi = min(min(PL - 1, xr + s - px0), W - 2 - px0);
        const int ncol = j_hi - j_lo + 1;
        const Job jb = {img, H, W, P, PL, py0, px0, y_off, x, y, ang, crsbp,
                        srsbp};

        // this warp's tile: the box around the rotated square of half-side
        // SBP at the tile centre, clipped to the scan bounds
        const float half = sbp * (fabsf(ca) + fabsf(sa)) + 1.0f;
        const float tcx = x + sbp * (ca * cent_x - sa * cent_y);
        const float tcy = y + sbp * (sa * cent_x + ca * cent_y);
        const int jb_lo = max(j_lo, (int)floorf(tcx - half) - px0);
        const int jb_hi = min(j_hi, (int)ceilf(tcx + half) - px0);
        const int ib_lo = max(i_lo, (int)floorf(tcy - half) - y_off - py0);
        const int ib_hi = min(i_hi, (int)ceilf(tcy + half) - y_off - py0);
        const int bw = jb_hi - jb_lo + 1;
        const float inv_bw = bw > 0 ? 1.0f / (float)bw : 0.0f;

        float acc[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[b] = 0.f;

        if (ncol > 0 && i_hi >= i_lo) {
            const int band_rows = max(1, CAP / ncol);
            const float inv_ncol = 1.0f / (float)ncol;
            for (int i0 = i_lo; i0 <= i_hi; i0 += band_rows) {
                const int i1 = min(i_hi, i0 + band_rows - 1);
                const int npix = (i1 - i0 + 1) * ncol;
                // stage the band's pixel terms, each computed once
                for (int q = t; q < npix; q += NT) {
                    const int ri = div_small(q, inv_ncol);
                    float nxg, nyg, c0, c1;
                    int fo0;
                    pixel_terms<PATCH>(jb, i0 + ri, j_lo + q - ri * ncol, nxg,
                                       nyg, c0, c1, fo0);
                    s_nx[q] = nxg;
                    s_ny[q] = nyg;
                    s_c0[q] = c0;
                    s_c1[q] = c1;
                    s_fo[q] = fo0;
                }
                __syncthreads();
                // the tile's box inside this band, lanes in a fixed stride
                const int r0 = max(ib_lo, i0);
                const int r1 = min(ib_hi, i1);
                const int cnt = (bw > 0 && r1 >= r0) ? (r1 - r0 + 1) * bw : 0;
                for (int p = lane; p < cnt; p += 32) {
                    const int ri = div_small(p, inv_bw);
                    const int q = (r0 - i0 + ri) * ncol
                                + (jb_lo - j_lo) + p - ri * bw;
                    const float ax = fabsf(s_nx[q] - cent_x);
                    const float ay = fabsf(s_ny[q] - cent_y);
                    const float wx = ax < 1.0f ? 1.0f - ax : 0.0f;
                    const float wy = ay < 1.0f ? 1.0f - ay : 0.0f;
                    const int f0 = s_fo[q];
                    const int f1 = (f0 + 1) & 7;
                    const float v0 = (wy * s_c0[q]) * wx;
                    const float v1 = (wy * s_c1[q]) * wx;
#pragma unroll
                    for (int b = 0; b < 8; ++b)
                        acc[b] += (b == f0) ? v0 : ((b == f1) ? v1 : 0.0f);
                }
                __syncthreads();
            }
        }
        // a fixed tree over the 32 lanes ends each bin
#pragma unroll
        for (int b = 0; b < 8; ++b) {
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], d);
        }
        float r = acc[0];
#pragma unroll
        for (int b = 1; b < 8; ++b) r = (lane == b) ? acc[b] : r;
        if (lane < 8) out[(size_t)k * 128 + tile * 8 + lane] = r;
    }
}

template <bool PATCH>
int launch(const OctaveTable& tab, int n_rows, const float* x, const float* y,
           const float* sigma, const int* level, const float* ang,
           const uint8_t* valid, int radius, const int* y0, const int* x0,
           int P, int PL, float* out, void* stream) {
    const int side = PATCH ? PL : 2 * radius + 1;
    if (n_rows < 1 || side < 1 || side > CAP)
        return (int)cudaErrorInvalidValue;
    const int grid = n_rows < MAX_GRID ? n_rows : MAX_GRID;
    descriptor_loop_kernel<PATCH><<<grid, NT, 0, (cudaStream_t)stream>>>(
        tab, n_rows, x, y, sigma, level, ang, valid, radius, y0, x0, P, PL,
        out);
    return (int)cudaGetLastError();
}

}  // namespace

// One launch over the job rows of n_oct octaves. `table` is a host array
// i64[n_oct, 8]: blur stack address (f32[L, H, W]), L, H, W, the end of the
// octave's rows in the job arrays (ascending; the last is the row count),
// the global row of the stack's row 0 and the inclusive global scan rows
// (y_lo, y_hi): 0, 1 and H-2 for a whole octave.
// `out` f32[rows, 128] is written for valid rows only.
extern "C" int ps_descriptor_loop_octaves(const long long* table, int n_oct,
                                          const float* x, const float* y,
                                          const float* sigma, const int* level,
                                          const float* ang,
                                          const uint8_t* valid, int radius,
                                          float* out, void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT) return (int)cudaErrorInvalidValue;
    OctaveTable tab = {};
    tab.n = n_oct;
    for (int o = 0; o < n_oct; ++o) {
        const long long* r = table + 8 * o;
        for (int c = 5; c < 8; ++c)
            if (r[c] < -0x40000000LL || r[c] > 0x40000000LL)
                return (int)cudaErrorInvalidValue;
        tab.src[o] = (const float*)(uintptr_t)r[0];
        tab.L[o] = (int)r[1];
        tab.H[o] = (int)r[2];
        tab.W[o] = (int)r[3];
        tab.row_end[o] = (int)r[4];
        tab.y_off[o] = (int)r[5];
        tab.y_lo[o] = (int)r[6];
        tab.y_hi[o] = (int)r[7];
    }
    return launch<false>(tab, tab.row_end[n_oct - 1], x, y, sigma, level, ang,
                         valid, radius, nullptr, nullptr, 0, 0, out, stream);
}

// The single-octave form: rows [0, n) of one f32[L, H, W] stack.
extern "C" int ps_descriptor_loop(const float* blur, int L, int H, int W,
                                  const float* x, const float* y,
                                  const float* sigma, const int* level,
                                  const float* ang, const uint8_t* valid,
                                  int n, int radius, float* out,
                                  void* stream) {
    OctaveTable tab = {};
    tab.n = 1;
    tab.src[0] = blur;
    tab.L[0] = L;
    tab.H[0] = H;
    tab.W[0] = W;
    tab.row_end[0] = n;
    tab.y_lo[0] = 1;      // y_off 0: the whole octave
    tab.y_hi[0] = H - 2;
    return launch<false>(tab, n, x, y, sigma, level, ang, valid, radius,
                         nullptr, nullptr, 0, 0, out, stream);
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
    OctaveTable tab = {};
    tab.n = 1;
    tab.src[0] = patches;
    tab.H[0] = H;
    tab.W[0] = W;
    tab.row_end[0] = n;
    tab.y_lo[0] = 1;      // y_off 0: the whole octave
    tab.y_hi[0] = H - 2;
    return launch<true>(tab, n, x, y, sigma, nullptr, ang, valid, 0, y0, x0,
                        P, PL, out, stream);
}
