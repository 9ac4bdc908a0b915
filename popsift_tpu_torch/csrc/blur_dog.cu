// K5: fused separable Gaussian blur + DoG of one pyramid level.
//
// Replaces: popsift_tpu/ops/pallas/blur.py:blur_and_dog (the Pallas call at
// :102), which the JAX package ran once per (octave, level).
//
// What bounds it on the H100: bytes in principle (one level reads blur_{l-1}
// once and writes blur_l and DoG_{l-1} once: 12 bytes a pixel, about 0.66 GB
// per 1080p frame over all octaves), instruction issue in practice: with
// -fmad=false an output costs 2 (3S + 1) float operations (S = 5..13 at the
// default filters), and every shared load, address computation and loop
// guard beside them takes an issue slot too. The thin octaves are bound by
// the launch itself: a launch lasts as long as one block's march.
//
// What the design does about it:
//  * A block owns a strip of 128 columns and a band of rows and marches
//    down it, eight rows a step. Each warp takes one new input row of the
//    strip (coalesced, clamped reads: edge replication, the reference's
//    clamped texture, assist.h:66-81) with S halo columns a side, runs the
//    horizontal pass on it and puts the result into a ring of the last
//    2S + 24 horizontal rows in shared memory. The horizontal pass runs
//    once per row (plus 2S warm-up rows a band), not once per tile halo.
//    The next step's row is fetched into registers before this step's
//    passes, so its latency hides behind them; one barrier a step.
//  * Outputs from registers. In both passes a thread produces four outputs
//    along the pass direction from a register window of 4 + 2S values loaded
//    once (16-byte shared loads in the horizontal pass, one column of the
//    ring in the vertical): (4 + 2S) / 4 loads an output and pass, where a
//    tile kernel that reads every neighbour from shared memory needs 2S + 1.
//  * The half-width S is a template parameter, one kernel for each S up to
//    24: windows are exactly as long as the filter, every register index
//    and shared offset is a compile-time constant, the taps come straight
//    from the kernel's parameters, and no loop or load carries a run-time
//    guard. Column indices and plane pointers are computed once before the
//    march (the compiler does not hoist them across the barrier). Each ring
//    row is stored twice, RING rows apart, so a vertical window never wraps.
//  * Rows outside the plane are the horizontal pass of the clamped input
//    row, so the vertical pass needs no clamping, and planes smaller than a
//    strip or than the filter work unchanged.
//  * Bands are sized on the host so that a launch has about eight blocks
//    for each SM where the plane allows it, down to eight rows a band: a
//    thin plane is cut into many short marches rather than a few long ones.
//  * The launch that writes level L - 3 can also write the next octave's
//    level 0: every second pixel of the blur goes to a second output
//    (`pick`), which saves the pyramid a strided copy per octave.
//  * One launch per level covers every plane of a [N, H, W] batch (grid z =
//    plane); planes may be strided (a level of a [N, L, H, W] stack).
//  * The thinnest octaves take one launch for all their levels: see
//    blur_dog_thin_kernel below.
//
// Arithmetic follows popsift_tpu_torch/ops/kernels/blur_dog.py:_sep_blur, the
// JAX shift-and-add order: horizontal before vertical, the centre tap first,
// then acc = acc + (left + right) * tap[off] for off = 1..S, one rounding per
// operation (the library is built with -fmad=false). The DoG is a separate
// subtraction. So the kernel equals its plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW = 128;    // strip width: output columns of a block
constexpr int RV = 8;      // rows per step (one warp each)
constexpr int RUN = 4;     // outputs a thread produces per pass and step
constexpr int NT = 256;    // RV warps; SW columns x two half-steps
constexpr int MAX_S = 24;  // widest half-filter taken
constexpr int MIN_BAND = 8;       // least rows of a band
constexpr int WANT_BLOCKS = 1056;  // eight for each of the card's 132 SMs

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct Taps {
    float t[MAX_S + 1];    // t[0] centre, t[off] the pair at +-off
};

// Sizes for half-width S, all compile-time: the kernel is instantiated for
// every S up to MAX_S, so no loop or load carries a run-time guard.
template <int S>
struct Geometry {
    static constexpr int HS = (S + 3) / 4 * 4;    // staged halo: 16-byte steps
    static constexpr int PITCH = SW + 2 * HS;     // staged input row
    static constexpr int NPRE = (SW + 2 * S + 31) / 32;  // its values per lane
    static constexpr int RING = 2 * S + 24;       // horizontal rows kept
    static constexpr int HWIN = RUN + 2 * HS;     // horizontal window
    static constexpr int VWIN = RUN + 2 * S;      // vertical window
    static constexpr size_t SMEM =
        sizeof(float) * (size_t)(RV * PITCH + 2 * RING * SW);
};

// The symmetric filter over a register window: output e = 0..RUN-1 has its
// centre at w[C + e]. Centre tap first, then the pairs outward, one rounding
// per operation.
template <int S, int C>
__device__ __forceinline__ void filter_window(const float* w,
                                              const Taps& taps, float* acc) {
#pragma unroll
    for (int e = 0; e < RUN; ++e) acc[e] = w[C + e] * taps.t[0];
#pragma unroll
    for (int off = 1; off <= S; ++off) {
        const float tp = taps.t[off];
#pragma unroll
        for (int e = 0; e < RUN; ++e)
            acc[e] = acc[e] + (w[C + e - off] + w[C + e + off]) * tp;
    }
}

template <int S>
__global__ void __launch_bounds__(NT)
blur_dog_kernel(const float* __restrict__ src, long long src_stride,
                float* __restrict__ blur, long long blur_stride,
                float* __restrict__ dog, long long dog_stride,
                float* __restrict__ pick, long long pick_stride, int OH,
                int OW, int H, int W, int BH, Taps taps) {
    using G = Geometry<S>;
    extern __shared__ float4 smem4[];
    float* inb = reinterpret_cast<float*>(smem4);   // [RV][PITCH]
    float* ring = inb + RV * G::PITCH;              // [2 RING][SW]
    const int p = blockIdx.z;
    const float* s = src + (size_t)p * (size_t)src_stride;
    const int bx = blockIdx.x * SW;
    const int yb0 = blockIdx.y * BH;
    const int bh = min(BH, H - yb0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    // virtual row rv of the band is image row yb0 - S + rv, clamped; output
    // row k of the band has its centre at rv = k + S
    const int nrv = bh + 2 * S;
    const int n_chunks = (bh + RV - 1) / RV;

    // Horizontal pass, one row a warp. Staged column b is image column
    // bx - HS + b; lane l fetches image columns bx - S + l + 32 m (clamped:
    // edge replication) and makes output columns 4l..4l+3 from the window
    // staged[4l .. 4l + HWIN), whose centre for output e is at HS + e.
    int cx[G::NPRE];
#pragma unroll
    for (int m = 0; m < G::NPRE; ++m)
        cx[m] = clampi(bx - S + lane + 32 * m, 0, W - 1);
    float* stage = inb + warp * G::PITCH + (G::HS - S) + lane;
    const float4* hwin =
        reinterpret_cast<const float4*>(inb + warp * G::PITCH + RUN * lane);
    float4* ring4 = reinterpret_cast<float4*>(ring) + lane;
    // Vertical pass: thread (c, half) makes output rows k4..k4+3 of column c
    // from ring rows k4 .. k4 + 3 + 2S (window index i is virtual row k4 + i)
    const int c = tid & (SW - 1);
    const int half = tid >> 7;
    const int x = min(bx + c, W - 1);
    const bool in_x = bx + c < W;
    const float* below_col = s + x;
    float* blur_col = blur + (size_t)p * (size_t)blur_stride + x;
    float* dog_col = dog + (size_t)p * (size_t)dog_stride + x;
    float* pick_col = pick == nullptr ? nullptr
        : pick + (size_t)p * (size_t)pick_stride + (x >> 1);
    const bool pick_x = in_x && !(x & 1) && (x >> 1) < OW;

    float pre[G::NPRE];      // the warp's next row, in registers
    int oc = 0;              // next chunk of RV output rows
    if (warp < nrv) {
        const float* row = s + (size_t)clampi(yb0 - S + warp, 0, H - 1) * W;
#pragma unroll
        for (int m = 0; m < G::NPRE; ++m)
            if (lane + 32 * m < SW + 2 * S) pre[m] = row[cx[m]];
    }
    for (int hv = 0; hv < nrv; hv += RV) {
        const int rv = hv + warp;
        if (rv < nrv) {
#pragma unroll
            for (int m = 0; m < G::NPRE; ++m)
                if (lane + 32 * m < SW + 2 * S) stage[32 * m] = pre[m];
            __syncwarp();
        }
        // the next step's row is in flight while this step computes
        if (rv + RV < nrv) {
            const float* row =
                s + (size_t)clampi(yb0 - S + rv + RV, 0, H - 1) * W;
#pragma unroll
            for (int m = 0; m < G::NPRE; ++m)
                if (lane + 32 * m < SW + 2 * S) pre[m] = row[cx[m]];
        }
        if (rv < nrv) {
            float w[G::HWIN];
#pragma unroll
            for (int m = 0; m < G::HWIN / 4; ++m) {
                if (4 * m + 3 >= G::HS - S && 4 * m < G::HS + RUN + S) {
                    const float4 v = hwin[m];
                    w[4 * m] = v.x;
                    w[4 * m + 1] = v.y;
                    w[4 * m + 2] = v.z;
                    w[4 * m + 3] = v.w;
                }
            }
            float acc[RUN];
            filter_window<S, G::HS>(w, taps, acc);
            // each ring row is kept twice, RING rows apart, so that a
            // vertical window never wraps
            const float4 hz = make_float4(acc[0], acc[1], acc[2], acc[3]);
            const int slot = rv % G::RING;
            ring4[slot * (SW / 4)] = hz;
            ring4[(slot + G::RING) * (SW / 4)] = hz;
        }
        __syncthreads();
        // vertical pass over every chunk of output rows whose 2S rows below
        // are in the ring now
        const int done = min(hv + RV, nrv);
        while (oc < n_chunks && min(RV * oc + RV, bh) + 2 * S <= done) {
            const int k4 = RV * oc + RUN * half;    // first output row
            const size_t o = (size_t)(yb0 + k4) * W;
            const int left = bh - k4;               // output rows that exist
            // the level below at the outputs, asked for before the filter
            float below[RUN];
#pragma unroll
            for (int e = 0; e < RUN; ++e)
                below[e] = e < left ? below_col[o + (size_t)e * W] : 0.f;
            const float* col = ring + (k4 % G::RING) * SW + c;
            float w[G::VWIN];
#pragma unroll
            for (int i = 0; i < G::VWIN; ++i) w[i] = col[i * SW];
            float acc[RUN];
            filter_window<S, S>(w, taps, acc);
            if (in_x) {
#pragma unroll
                for (int e = 0; e < RUN; ++e) {
                    if (e < left) {
                        blur_col[o + (size_t)e * W] = acc[e];
                        dog_col[o + (size_t)e * W] = acc[e] - below[e];
                    }
                }
                if (pick_col != nullptr && pick_x) {
                    // bands start on even rows and k4 is a multiple of 4:
                    // rows k4 and k4 + 2 are the even ones
#pragma unroll
                    for (int e = 0; e < RUN; e += 2) {
                        const int y2 = (yb0 + k4 + e) >> 1;
                        if (e < left && y2 < OH)
                            pick_col[(size_t)y2 * OW] = acc[e];
                    }
                }
            }
            ++oc;
        }
    }
}

template <int S>
int launch(const float* src, long long src_stride, float* blur,
           long long blur_stride, float* dog, long long dog_stride,
           float* pick, long long pick_stride, int OH, int OW, int N, int H,
           int W, const Taps& t, cudaStream_t stream) {
    using G = Geometry<S>;
    if (G::SMEM > 48 * 1024) {   // S >= 10: opt in, on the current device
        cudaError_t rc = cudaFuncSetAttribute(
            blur_dog_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)G::SMEM);
        if (rc != cudaSuccess) return (int)rc;
    }
    // bands: enough blocks to fill the card, each at least MIN_BAND rows
    // (a band pays 2S warm-up rows of the horizontal pass, and a launch
    // lasts as long as one block's march)
    const int strips = (W + SW - 1) / SW;
    int bands = (WANT_BLOCKS + strips * N - 1) / (strips * N);
    const int most = (H + MIN_BAND - 1) / MIN_BAND;
    if (bands > most) bands = most;
    int BH = (H + bands - 1) / bands;
    BH = (BH + RV - 1) / RV * RV;
    const dim3 grid(strips, (H + BH - 1) / BH, N);
    blur_dog_kernel<S><<<grid, NT, G::SMEM, stream>>>(
        src, src_stride, blur, blur_stride, dog, dog_stride, pick,
        pick_stride, OH, OW, H, W, BH, t);
    return (int)cudaGetLastError();
}

// The thin octaves in one launch. An octave whose plane fits a block's shared
// memory three times over (the level below, the horizontal pass, the new
// level) needs no strips, bands or halo: one block a frame keeps the plane in
// shared memory and runs every level of every such octave, and the picks
// between them, with the same terms in the same order as the strip kernel.
// What bounds those octaves is launch latency (a level launch lasts at
// least 2.6 us however few its pixels), and this entry is one launch. One
// block is one SM, about 9 ns a pixel for five levels, so the caller sends
// only planes of a few thousand pixels (ops/kernels/blur_dog.py::thin_fits).
constexpr int THIN_NT = 1024;
constexpr int THIN_MAX_OCT = 8;
constexpr int THIN_MAX_LEVELS = 12;
constexpr size_t THIN_SMEM_MAX = 232448;   // what a block may use on sm_90

struct ThinArgs {
    float* blur[THIN_MAX_OCT];   // f32[N, L, H, W], level 0 of the first filled
    float* dog[THIN_MAX_OCT];    // f32[N, L - 1, H, W]
    int H[THIN_MAX_OCT];
    int W[THIN_MAX_OCT];
    int n_oct, L, pick_level;    // pick_level: the level the next octave takes
    int span[THIN_MAX_LEVELS];   // half-width of level l + 1's filter
    float taps[THIN_MAX_LEVELS][MAX_S + 1];
};

__global__ void __launch_bounds__(THIN_NT)
blur_dog_thin_kernel(ThinArgs a) {
    extern __shared__ float4 smem4[];
    const int cap = a.H[0] * a.W[0];
    float* prev = reinterpret_cast<float*>(smem4);   // the level below
    float* hz = prev + cap;                          // its horizontal pass
    float* cur = hz + cap;                           // the new level
    const int f = blockIdx.x;
    const int tid = threadIdx.x;
    for (int o = 0; o < a.n_oct; ++o) {
        const int H = a.H[o];
        const int W = a.W[o];
        const int n = H * W;
        float* bl = a.blur[o] + (size_t)f * a.L * n;
        float* dg = a.dog[o] + (size_t)f * (a.L - 1) * n;
        const bool picks = o + 1 < a.n_oct;
        const int OH = picks ? a.H[o + 1] : 0;
        const int OW = picks ? a.W[o + 1] : 0;
        float* nxt = picks ? a.blur[o + 1] + (size_t)f * a.L * OH * OW
                           : nullptr;
        // level 0: written by the launch before this one, or by this block
        // while it ran the octave above (the barrier below orders both)
        __syncthreads();
        for (int i = tid; i < n; i += THIN_NT) prev[i] = bl[i];
        __syncthreads();
        for (int l = 1; l < a.L; ++l) {
            const int S = a.span[l - 1];
            const float* t = a.taps[l - 1];
            for (int i = tid; i < n; i += THIN_NT) {
                const int y = i / W;
                const int x = i - y * W;
                const float* row = prev + y * W;
                float acc = row[x] * t[0];
                for (int off = 1; off <= S; ++off)
                    acc = acc + (row[max(x - off, 0)]
                                 + row[min(x + off, W - 1)]) * t[off];
                hz[i] = acc;
            }
            __syncthreads();
            for (int i = tid; i < n; i += THIN_NT) {
                const int y = i / W;
                const int x = i - y * W;
                float acc = hz[i] * t[0];
                for (int off = 1; off <= S; ++off)
                    acc = acc + (hz[max(y - off, 0) * W + x]
                                 + hz[min(y + off, H - 1) * W + x]) * t[off];
                cur[i] = acc;
                bl[(size_t)l * n + i] = acc;
                dg[(size_t)(l - 1) * n + i] = acc - prev[i];
                if (picks && l == a.pick_level && !((x | y) & 1)
                    && (y >> 1) < OH && (x >> 1) < OW)
                    nxt[(y >> 1) * OW + (x >> 1)] = acc;
            }
            __syncthreads();
            float* swap = prev;
            prev = cur;
            cur = swap;
        }
    }
}

}  // namespace

// src, blur, dog: N planes of H x W f32, each plane dense, planes
// `*_stride` floats apart. taps: host array of S + 1 floats. pick: null, or
// N dense planes of OH x OW f32 that take blur[2y, 2x].
extern "C" int ps_blur_dog(const float* src, long long src_stride,
                           float* blur, long long blur_stride, float* dog,
                           long long dog_stride, float* pick,
                           long long pick_stride, int OH, int OW, int N,
                           int H, int W, const float* taps, int S,
                           void* stream) {
    if (S < 0 || S > MAX_S || N < 1 || H < 1 || W < 1 || N > 65535)
        return (int)cudaErrorInvalidValue;
    if (pick != nullptr && (OH < 1 || OW < 1))
        return (int)cudaErrorInvalidValue;
    Taps t = {};
    for (int i = 0; i <= S; ++i) t.t[i] = taps[i];
    cudaStream_t st = (cudaStream_t)stream;
#define PS_CASE(S_)                                                          \
    case S_:                                                                 \
        return launch<S_>(src, src_stride, blur, blur_stride, dog,           \
                          dog_stride, pick, pick_stride, OH, OW, N, H, W, t, \
                          st);
    switch (S) {
        PS_CASE(0) PS_CASE(1) PS_CASE(2) PS_CASE(3) PS_CASE(4) PS_CASE(5)
        PS_CASE(6) PS_CASE(7) PS_CASE(8) PS_CASE(9) PS_CASE(10) PS_CASE(11)
        PS_CASE(12) PS_CASE(13) PS_CASE(14) PS_CASE(15) PS_CASE(16)
        PS_CASE(17) PS_CASE(18) PS_CASE(19) PS_CASE(20) PS_CASE(21)
        PS_CASE(22) PS_CASE(23) PS_CASE(24)
    }
#undef PS_CASE
    return (int)cudaErrorInvalidValue;
}

// Every level of the thin octaves of N frames in one launch, one block a
// frame. table: host array i64[n_oct, 4] of (blur stack f32[N, L, H, W],
// DoG stack f32[N, L - 1, H, W], H, W), octaves in order, each at most half
// the one before; level 0 of the first stack is the input, every other level,
// every DoG layer and level 0 of the later stacks (every second pixel of
// level `pick_level` of the octave above) are written. taps: host array
// f32[L - 1, MAX_S + 1], row l - 1 holding level l's centre and pairs;
// spans: its L - 1 half-widths. Returns cudaErrorInvalidValue for what the
// entry does not take (a first plane beyond a third of the shared memory).
extern "C" int ps_blur_dog_thin(const long long* table, int n_oct, int N,
                                int L, int pick_level, const float* taps,
                                const int* spans, void* stream) {
    if (n_oct < 1 || n_oct > THIN_MAX_OCT || N < 1 || L < 2
        || L - 1 > THIN_MAX_LEVELS || pick_level < 1 || pick_level >= L)
        return (int)cudaErrorInvalidValue;
    ThinArgs a = {};
    a.n_oct = n_oct;
    a.L = L;
    a.pick_level = pick_level;
    for (int o = 0; o < n_oct; ++o) {
        a.blur[o] = (float*)(uintptr_t)table[4 * o];
        a.dog[o] = (float*)(uintptr_t)table[4 * o + 1];
        a.H[o] = (int)table[4 * o + 2];
        a.W[o] = (int)table[4 * o + 3];
        if (a.H[o] < 1 || a.W[o] < 1
            || (o > 0 && (a.H[o] > (a.H[o - 1] + 1) / 2
                          || a.W[o] > (a.W[o - 1] + 1) / 2)))
            return (int)cudaErrorInvalidValue;
    }
    for (int l = 0; l < L - 1; ++l) {
        if (spans[l] < 0 || spans[l] > MAX_S)
            return (int)cudaErrorInvalidValue;
        a.span[l] = spans[l];
        for (int i = 0; i <= spans[l]; ++i)
            a.taps[l][i] = taps[l * (MAX_S + 1) + i];
    }
    const size_t smem = sizeof(float) * 3 * (size_t)a.H[0] * (size_t)a.W[0];
    if (smem > THIN_SMEM_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        blur_dog_thin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    blur_dog_thin_kernel<<<N, THIN_NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
