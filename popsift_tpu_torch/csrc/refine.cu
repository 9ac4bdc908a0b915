// K2: 5-step sub-pixel refinement of DoG extremum candidates.
//
// Replaces: popsift_tpu/ops/pallas/refine.py:refine_windows_pallas, the fused
// window read + refinement of the TPU path. (The separate window copy of the
// unfused route, pallas/window.py:extract_windows_pallas, is K6, window.cu.)
//
// What bounds it on the H100: latency. A candidate touches 27 floats per
// step for at most 5 steps, and an octave has at most a few thousand live
// candidates, so the kernel moves a few MB at most; what costs is the
// dependent chain of loads -> solve -> step.
//
// What the design does about it: one thread per candidate, in registers, as
// the reference does (s_extrema.cu:359-460). The thread reads its
// 27-neighbourhood straight from the dense DoG stack (L1/L2 serve the
// overlap between steps and between neighbouring candidates) instead of
// copying windows; only rows below the live count n are launched.
//
// Arithmetic follows popsift_tpu/ops/extrema.py:refine_candidates op for op
// in f32: derivatives (:672-683), the adjugate solve _solve3 (:137-156) and
// the step policy (:704-720; vlfeat keeps tz = 0). The library is built with
// -fmad=false so no multiply-add is contracted; the plain PyTorch version
// (ops/kernels/refine.py) rounds the same way, op by op. z reads are clamped
// to [0, D-1] as `neighborhood` does (:630); x/y reads are clamped to the
// image, the JAX twin's edge-padded window (never binding: the step policy
// keeps every read inside the image).
//
// Frame-batched entry (replaces refine.py:refine_windows_pallas_batched):
// F frames' D-layer stacks lie back to back, f32[F*D, H, W], and the
// candidates are F*cap rows, frame-major. Row k belongs to frame
// f = k / cap and is live below that frame's n_found[f], read from a device
// array (no host read-back). The thread's volume starts at layer f*D, so
// the z clamp stays [f*D, f*D + D-1]: a candidate on a frame's top layer
// never reads the next frame. nz is written frame-local, as the JAX twin's
// per-job layer base (zbase) leaves it.
//
// All-octave entry (ps_refine_octaves; the extraction paths' only entry
// since the compaction kernel keeps the counts on the device): ONE launch
// over the candidate rows of all octaves and frames, laid out as the
// compaction writes them (frame f's octave o at rows f * Ktot + row_off[o]
// .. + cap[o]). A by-value table per octave holds the DoG stack (f32[F*D, H,
// W]), its D, H, W and the octave's last row; each thread finds its row's
// frame and octave, reads the live count n_found[f, o] from the device and
// refines the row, or writes its zeros. The grid covers every capacity row
// (73,728 on the 1080p bench plan), so no count sizes the launch and the
// host reads nothing back; one launch replaces one per octave, and the
// per-octave outputs need no concatenation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ITERATIONS = 5;
constexpr int NOUT = 16;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Refines one candidate starting at (nx, ny, nz) of the stack `dog`
// f32[D, H, W]; writes the NOUT-column state to o.
__device__ void refine_one(const float* __restrict__ dog, int nx, int ny,
                           int nz, int D, int H, int W, int maxlevel,
                           int vlfeat, float* __restrict__ o) {
    const size_t plane = (size_t)H * (size_t)W;
    float v = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    float Dx = 0.f, Dy = 0.f, Ds = 0.f, DDx = 0.f, DDy = 0.f, DXy = 0.f;

    for (int it = 1; it <= MAX_ITERATIONS; ++it) {
        float nb[3][3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float* layer =
                dog + (size_t)clampi(nz + a - 1, 0, D - 1) * plane;
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                const float* row =
                    layer + (size_t)clampi(ny + b - 1, 0, H - 1) * W;
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    nb[a][b][c] = __ldg(row + clampi(nx + c - 1, 0, W - 1));
            }
        }
        const float c0 = nb[1][1][1];
        if (it == 1) v = c0;   // contrast base, s_extrema.cu:357
        const float p2 = nb[1][1][2], p0 = nb[1][1][0];
        const float q2 = nb[1][2][1], q0 = nb[1][0][1];
        const float r2 = nb[2][1][1], r0 = nb[0][1][1];
        const float nDx = 0.5f * (p2 - p0);
        const float nDy = 0.5f * (q2 - q0);
        const float nDs = 0.5f * (r2 - r0);
        const float nDDx = p2 + p0 - 2.0f * c0;
        const float nDDy = q2 + q0 - 2.0f * c0;
        const float nDDs = r2 + r0 - 2.0f * c0;
        const float nDXy =
            0.25f * (nb[1][2][2] + nb[1][0][0] - nb[1][2][0] - nb[1][0][2]);
        const float nDXs =
            0.25f * (nb[2][1][2] + nb[0][1][0] - nb[2][1][0] - nb[0][1][2]);
        const float nDYs =
            0.25f * (nb[2][2][1] + nb[0][0][1] - nb[0][2][1] - nb[2][0][1]);

        // _solve3(a00=DDx, a01=DXy, a02=DXs, a11=DDy, a12=DYs, a22=DDs,
        //         b = -(Dx, Dy, Ds))
        const float a00 = nDDx, a01 = nDXy, a02 = nDXs;
        const float a11 = nDDy, a12 = nDYs, a22 = nDDs;
        const float b0 = -nDx, b1 = -nDy, b2 = -nDs;
        const float det0 = a11 * a22 - a12 * a12;
        const float det1 = a12 * a02 - a01 * a22;
        const float det2 = a01 * a12 - a11 * a02;
        const float det3 = a00 * a22 - a02 * a02;
        const float det4 = a01 * a02 - a00 * a12;
        const float det5 = a00 * a11 - a01 * a01;
        const float det = a00 * det0 + a01 * det1 + a02 * det2;
        const bool sing = det == 0.0f;
        float sx = 0.f, sy = 0.f, ss = 0.f;
        if (!sing) {
            const float rsd = 1.0f / det;
            sx = (det0 * b0 + det1 * b1 + det2 * b2) * rsd;
            sy = (det1 * b0 + det3 * b1 + det4 * b2) * rsd;
            ss = (det2 * b0 + det4 * b1 + det5 * b2) * rsd;
        }

        Dx = nDx;
        Dy = nDy;
        Ds = nDs;
        DDx = nDDx;
        DDy = nDDy;
        DXy = nDXy;
        dx = sx;
        dy = sy;
        dz = ss;
        if (it == MAX_ITERATIONS) break;

        // step policy (popsift s_extrema.cu:258-284; vlfeat :207-232)
        const int tx = ((sx >= 0.6f && nx < W - 2) ? 1 : 0)
                     - ((sx <= -0.6f && nx > 1) ? 1 : 0);
        const int ty = ((sy >= 0.6f && ny < H - 2) ? 1 : 0)
                     - ((sy <= -0.6f && ny > 1) ? 1 : 0);
        const int tz = vlfeat ? 0
                     : ((ss >= 0.6f && nz < maxlevel - 1) ? 1 : 0)
                       - ((ss <= -0.6f && nz > 1) ? 1 : 0);
        if (sing || (tx == 0 && ty == 0 && tz == 0)) break;   // done
        nx += tx;
        ny += ty;
        nz += tz;
    }

    o[0] = (float)nx;
    o[1] = (float)ny;
    o[2] = (float)nz;
    o[3] = dx;
    o[4] = dy;
    o[5] = dz;
    o[6] = v;
    o[7] = Dx;
    o[8] = Dy;
    o[9] = Ds;
    o[10] = DDx;
    o[11] = DDy;
    o[12] = DXy;
    o[13] = 0.f;
    o[14] = 0.f;
    o[15] = 0.f;
}

__global__ void refine_kernel(const float* __restrict__ dog,
                              const int* __restrict__ x0,
                              const int* __restrict__ y0,
                              const int* __restrict__ z0, int n, int D, int H,
                              int W, int maxlevel, int vlfeat,
                              float* __restrict__ out) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) return;
    refine_one(dog, x0[k], y0[k], z0[k], D, H, W, maxlevel, vlfeat,
               out + (size_t)k * NOUT);
}

__global__ void refine_kernel_batched(const float* __restrict__ dog,
                                      const int* __restrict__ x0,
                                      const int* __restrict__ y0,
                                      const int* __restrict__ z0,
                                      const int* __restrict__ n_found, int F,
                                      int cap, int D, int H, int W,
                                      int maxlevel, int vlfeat,
                                      float* __restrict__ out) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= F * cap) return;
    const int f = k / cap;
    if (k - f * cap >= n_found[f]) return;    // rows past the count stay 0
    const float* vol = dog + (size_t)f * (size_t)D * (size_t)H * (size_t)W;
    refine_one(vol, x0[k], y0[k], z0[k], D, H, W, maxlevel, vlfeat,
               out + (size_t)k * NOUT);
}

constexpr int MAX_OCT = 16;

struct RefineTable {
    const float* dog[MAX_OCT];    // f32[F*D, H, W]
    int D[MAX_OCT];
    int H[MAX_OCT];
    int W[MAX_OCT];
    int row_end[MAX_OCT];         // rows [row_end[o-1], row_end[o]) of a frame
    int n;
};

__global__ void refine_octaves_kernel(RefineTable t,
                                      const int* __restrict__ x0,
                                      const int* __restrict__ y0,
                                      const int* __restrict__ z0,
                                      const long long* __restrict__ n_found,
                                      int F, int maxlevel, int vlfeat,
                                      float* __restrict__ out) {
    const int rows = t.row_end[t.n - 1];
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= (long long)F * rows) return;
    const int f = (int)(k / rows);
    int i = (int)(k - (long long)f * rows);
    int o = 0;
    while (i >= t.row_end[o]) ++o;
    if (o > 0) i -= t.row_end[o - 1];
    float* dst = out + k * NOUT;
    if (i >= n_found[(long long)f * t.n + o]) {   // rows past the count: zeros
        for (int c = 0; c < NOUT; ++c) dst[c] = 0.f;
        return;
    }
    const int D = t.D[o], H = t.H[o], W = t.W[o];
    const float* vol = t.dog[o] + (size_t)f * (size_t)D * (size_t)H * (size_t)W;
    refine_one(vol, x0[k], y0[k], z0[k], D, H, W, maxlevel, vlfeat, dst);
}

}  // namespace

extern "C" int ps_refine(const float* dog, const int* x0, const int* y0,
                         const int* z0, int n, int D, int H, int W,
                         int maxlevel, int vlfeat, float* out, void* stream) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    refine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dog, x0, y0, z0, n, D, H, W, maxlevel, vlfeat, out);
    return (int)cudaGetLastError();
}

extern "C" int ps_refine_batched(const float* dog, const int* x0,
                                 const int* y0, const int* z0,
                                 const int* n_found, int F, int cap, int D,
                                 int H, int W, int maxlevel, int vlfeat,
                                 float* out, void* stream) {
    const int threads = 128;
    const int blocks = (F * cap + threads - 1) / threads;
    refine_kernel_batched<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dog, x0, y0, z0, n_found, F, cap, D, H, W, maxlevel, vlfeat, out);
    return (int)cudaGetLastError();
}

// One launch over the candidate rows of n_oct octaves of F frames. `table` is
// a host array i64[n_oct, 5]: DoG address (f32[F*D, H, W]), D, H, W and the
// octave's last row within a frame (its first is the previous octave's
// last); x0, y0, z0 are i32[F * rows], n_found i64[F, n_oct], out
// f32[F * rows, 16], every row written.
extern "C" int ps_refine_octaves(const long long* table, int n_oct, int F,
                                 const int* x0, const int* y0, const int* z0,
                                 const long long* n_found, int maxlevel,
                                 int vlfeat, float* out, void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT || F < 1) return (int)cudaErrorInvalidValue;
    RefineTable t = {};
    t.n = n_oct;
    long long prev = 0;
    for (int o = 0; o < n_oct; ++o) {
        const long long* r = table + 5 * o;
        if (r[1] < 1 || r[2] < 1 || r[3] < 1 || r[4] < prev
            || r[4] > 0x7fffffffLL / F)
            return (int)cudaErrorInvalidValue;
        t.dog[o] = (const float*)(uintptr_t)r[0];
        t.D[o] = (int)r[1];
        t.H[o] = (int)r[2];
        t.W[o] = (int)r[3];
        t.row_end[o] = (int)r[4];
        prev = r[4];
    }
    const long long n = (long long)F * t.row_end[n_oct - 1];
    if (n == 0) return (int)cudaSuccess;
    const int threads = 128;
    const int blocks = (int)((n + threads - 1) / threads);
    refine_octaves_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        t, x0, y0, z0, n_found, F, maxlevel, vlfeat, out);
    return (int)cudaGetLastError();
}
