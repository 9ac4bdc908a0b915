// K7: fused chain of blur levels and their DoGs for one group of levels.
//
// Replaces: popsift_tpu/ops/pallas/blur.py:octave_blur_chain (the Pallas call
// in _octave_chain_call at :279), the opt-in front that computes levels
// 1..L-1 of an octave and their DoGs from level 0, in groups of `group`
// levels.
//
// What bounds it on the H100: bytes in principle, instruction issue in
// practice. Level by level (K5) every level is written and read back: 12
// bytes a pixel a level. Fused, a group of n levels reads its first input
// once and writes n blurs and n DoGs, 4 + 8n bytes a pixel. But a tile must
// stage its input with the cumulative halo Scum (the sum of the group's
// half-widths) on every side and recompute the shrinking halo at every
// level, and with -fmad=false every output of a pass costs 3S + 1 float
// operations (S = 5..13 at the default filters), each a separate issue.
//
// What the design does about it:
//  * One block computes one T x T output tile of every level of the group
//    for one plane (grid z = plane, so all frames of a batch go in one
//    launch). It stages the input tile plus Scum pixels a side in shared
//    memory once, with clamped reads (edge replication) of which each thread
//    has sixteen in flight before it stores the first (a load that waits
//    for its store before the next is issued made the staging, not the
//    arithmetic, the kernel's time), then runs each level over the region
//    whose halo is still valid; the region shrinks by that level's
//    half-width S.
//  * Outputs from registers. In both passes a thread makes RUN = 8 outputs
//    along the pass axis from a register window of RUN + 2S values loaded
//    once from shared memory: (8 + 2S) / 8 shared loads an output and pass,
//    where reading both neighbours of every tap from shared memory costs
//    2S + 1. In the horizontal pass the 32 lanes of a warp take 32
//    consecutive rows and in the vertical pass 32 consecutive columns; the
//    row pitch is odd, so neither pass has a bank conflict.
//  * The half-width is a template parameter (one instantiation of the level
//    step for each S up to 24, chosen by a switch once a level): windows are
//    exactly as long as the filter and every register index is a
//    compile-time constant. The taps sit in registers for the level.
//  * Two buffers: the level below and the horizontal pass (kept
//    transposed, so that the vertical pass's windows are consecutive
//    words). The vertical pass reads the level below at its own outputs (the
//    DoG) before it writes the new level over it, so no third buffer is
//    needed, a block takes at most about 112 KB at T = 64, and two blocks
//    share an SM: one block's staging loads overlap the other's arithmetic.
//  * Runs of outputs start at positions aligned to the tile, so a run lies
//    wholly inside the tile or wholly outside it: a run inside writes its
//    blur and DoG with no test per output.
//  * A tile whose staged region crosses the image border re-replicates each
//    level's own border after the level (every staged position outside the
//    image takes the level's value at the clamped position, which the same
//    tile holds). Without that, levels >= 2 would see "the blur of
//    replicated level 0" in the halo instead of "the replicated blur"
//    (blur.py:230-252). Interior tiles skip it.
//  * The host picks the widest side up to T = 64, a multiple of 8, whose
//    buffers let two blocks share an SM (56 for the default filters' second
//    group), and narrows it by 8 while the launch would have fewer than two
//    tiles for each SM, down to 16: the small octaves are bound by one
//    block's latency, not by the recomputed halo.
//  * Measured on the 1080p frame's octave 0 (PERF.md, an H100): the
//    arithmetic with its recomputed halo (1.6 x the tile's own) takes about
//    80 % of the time and issues at about half the SM's rate, the staging
//    about 20 %, the stores nothing; more threads a block or groups of two
//    levels did not change that by more than 7 %.
//  * The launch whose group holds the level the next octave is made from can
//    also write every second pixel of it (`pick`), the next octave's level 0.
//
// Arithmetic is K5's (blur_dog.cu), term for term: horizontal before
// vertical, the centre tap first, then acc = acc + (left + right) * tap[off]
// outward, one rounding per operation (-fmad=false), the DoG a separate
// subtraction. So every level equals K5's, and the plain version's, bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads of a block (8 warps)
constexpr int RUN = 8;         // outputs a thread makes per pass and task
constexpr int MARGIN = RUN - 1;   // staged positions kept beyond the halo
constexpr int MAX_S = 24;      // widest half-filter taken
constexpr int MAX_LEVELS = 5;  // most levels of one group
constexpr int MAX_T = 64;      // widest tile side
constexpr int WANT_TILES = 264;   // two blocks for each of the card's 132 SMs
// dynamic shared memory of a block: at most SMEM_TWO lets two blocks share
// an SM (228 KB, less 1 KB a block for the system and the taps); a block
// alone may take the 227 KB of an SM less 1 KB for its static arrays
constexpr size_t SMEM_TWO = 115000;
constexpr size_t SMEM_LIMIT = 226 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct ChainArgs {
    const float* src;        // N planes of H x W, src_stride floats apart
    float* blur;             // N planes of n levels of H x W
    float* dog;
    float* pick;             // null, or N planes of OH x OW
    long long src_stride, blur_stride, blur_lstride, dog_stride, dog_lstride;
    long long pick_stride;
    int H, W, T, Scum, n;
    int pick_level;          // the level of the group picked, or -1
    int OH, OW;
    int S[MAX_LEVELS];              // half-width per level
    float t[MAX_LEVELS][MAX_S + 1]; // t[l][0] centre, t[l][off] pair at +-off
};

// Staged geometry of a block: side PW = T + 2 Scum plus MARGIN positions on
// each side (a run of RUN outputs aligned to the tile may start up to
// RUN - 1 positions before the halo), with an odd row pitch.
__host__ __device__ inline int pitch_of(int T, int Scum) {
    return (T + 2 * Scum + 2 * MARGIN) | 1;
}
__host__ __device__ inline size_t smem_of(int T, int Scum) {
    const int side = T + 2 * Scum + 2 * MARGIN;
    return 2 * sizeof(float) * (size_t)side * (size_t)pitch_of(T, Scum);
}

// The symmetric filter over a register window: output e has its centre at
// w[S + e]. Centre tap first, then the pairs outward, one rounding per
// operation.
template <int S>
__device__ __forceinline__ void filter_run(const float (&w)[RUN + 2 * S],
                                           const float (&tp)[S + 1],
                                           float (&acc)[RUN]) {
#pragma unroll
    for (int e = 0; e < RUN; ++e) acc[e] = w[S + e] * tp[0];
#pragma unroll
    for (int off = 1; off <= S; ++off) {
#pragma unroll
        for (int e = 0; e < RUN; ++e)
            acc[e] = acc[e] + (w[S + e - off] + w[S + e + off]) * tp[off];
    }
}

// Where a block stands: its plane, the image position of staged (0, 0) and
// the row pitch of its buffers.
struct Tile {
    int p, oy, ox, P;
};

// Task t of a pass covers minor index t % n and run t / n; a thread walks
// its tasks t = tid, tid + NT, ... with no division after the first.
struct TaskWalk {
    int run, i, dq, dr, n;
    __device__ __forceinline__ TaskWalk(int tid, int n_) : n(n_) {
        run = tid / n;
        i = tid - run * n;
        dq = NT / n;
        dr = NT - dq * n;
    }
    __device__ __forceinline__ void next() {
        i += dr;
        run += dq;
        if (i >= n) {
            i -= n;
            ++run;
        }
    }
};

// One level of the group. Staged position (r, c) of the level below is
// lv[(r + MARGIN) P + c + MARGIN]; the horizontal pass is kept transposed,
// hz[(c + MARGIN) P + r + MARGIN], so that both passes read their windows
// from consecutive addresses. Runs of RUN outputs start at a0 = Scum - mc
// (mc: the level's margin m rounded up to RUN), so a run lies wholly inside
// the tile or wholly outside it; outputs beyond the valid region are
// computed from stale values and never used.
//  1. horizontal pass: rows [lo_p, hi_p) of the level below, column runs
//     over [a0, Scum + T + mc); lanes walk rows;
//  2. vertical pass: columns [lo, hi), row runs over the same range; lanes
//     walk columns. A run inside the tile writes blur, DoG and pick to
//     global memory; unless this is the group's last level, the new level
//     replaces the level below in `lv`.
template <int S>
__device__ __forceinline__ void level_step(const ChainArgs& a,
                                           const Tile& tl, float* lv,
                                           float* hz, const float* tap, int l,
                                           int lo_p, int hi_p, int lo, int hi,
                                           int mc, bool keep) {
    const int tid = threadIdx.x;
    const int P = tl.P;
    const int T = a.T, Scum = a.Scum;
    const int a0 = Scum - mc;
    const int nrun = (T + 2 * mc) / RUN;
    float tp[S + 1];
#pragma unroll
    for (int i = 0; i <= S; ++i) tp[i] = tap[i];

    {
        const int nrows = hi_p - lo_p;
        const int tasks = nrows * nrun;
        TaskWalk tw(tid, nrows);
        for (int t = tid; t < tasks; t += NT, tw.next()) {
            const int r = lo_p + tw.i;
            const int c0 = a0 + tw.run * RUN;
            const float* rp = lv + (r + MARGIN) * P + c0 + MARGIN - S;
            float w[RUN + 2 * S];
#pragma unroll
            for (int i = 0; i < RUN + 2 * S; ++i) w[i] = rp[i];
            float acc[RUN];
            filter_run<S>(w, tp, acc);
            float* hp = hz + (c0 + MARGIN) * P + r + MARGIN;
#pragma unroll
            for (int e = 0; e < RUN; ++e) hp[e * P] = acc[e];
        }
    }
    __syncthreads();
    {
        const int ncols = hi - lo;
        const int tasks = ncols * nrun;
        float* b = a.blur + (size_t)tl.p * (size_t)a.blur_stride
                   + (size_t)l * (size_t)a.blur_lstride;
        float* d = a.dog + (size_t)tl.p * (size_t)a.dog_stride
                   + (size_t)l * (size_t)a.dog_lstride;
        float* pk = (l == a.pick_level)
            ? a.pick + (size_t)tl.p * (size_t)a.pick_stride : nullptr;
        const int W = a.W, H = a.H;
        TaskWalk tw(tid, ncols);
        for (int t = tid; t < tasks; t += NT, tw.next()) {
            const int c = lo + tw.i;
            const int r0 = a0 + tw.run * RUN;
            const float* cp = hz + (c + MARGIN) * P + r0 + MARGIN - S;
            float w[RUN + 2 * S];
#pragma unroll
            for (int i = 0; i < RUN + 2 * S; ++i) w[i] = cp[i];
            float acc[RUN];
            filter_run<S>(w, tp, acc);
            float* at = lv + (r0 + MARGIN) * P + c + MARGIN;
            const int x = tl.ox + c, y = tl.oy + r0;
            const bool in_tile = c >= Scum && c < Scum + T && x < W
                                 && r0 >= Scum && r0 < Scum + T && y < H;
            if (in_tile && y + RUN <= H) {
                // the whole run lies in the tile and the image
                int o = y * W + x;
#pragma unroll
                for (int e = 0; e < RUN; ++e, o += W) {
                    b[o] = acc[e];
                    d[o] = acc[e] - at[e * P];
                }
                if (pk != nullptr && !(x & 1) && (x >> 1) < a.OW) {
                    // runs start on even rows: rows 0, 2, 4, 6 of the run
#pragma unroll
                    for (int e = 0; e < RUN; e += 2)
                        if (((y + e) >> 1) < a.OH)
                            pk[(size_t)((y + e) >> 1) * a.OW + (x >> 1)] =
                                acc[e];
                }
            } else if (in_tile) {
#pragma unroll
                for (int e = 0; e < RUN; ++e) {
                    if (y + e < H) {
                        const size_t o = (size_t)(y + e) * W + x;
                        b[o] = acc[e];
                        d[o] = acc[e] - at[e * P];
                        if (pk != nullptr && !((x | (y + e)) & 1)
                            && ((y + e) >> 1) < a.OH && (x >> 1) < a.OW)
                            pk[(size_t)((y + e) >> 1) * a.OW + (x >> 1)] =
                                acc[e];
                    }
                }
            }
            if (keep) {
#pragma unroll
                for (int e = 0; e < RUN; ++e) at[e * P] = acc[e];
            }
        }
    }
}

__global__ void __launch_bounds__(NT, 2) blur_chain_kernel(ChainArgs a) {
    extern __shared__ float smem[];
    __shared__ float s_tap[MAX_LEVELS][MAX_S + 1];
    const int tid = threadIdx.x;
    Tile tl;
    tl.p = blockIdx.z;
    tl.P = pitch_of(a.T, a.Scum);
    tl.oy = blockIdx.y * a.T - a.Scum;   // image row of staged row 0
    tl.ox = blockIdx.x * a.T - a.Scum;
    const int PW = a.T + 2 * a.Scum;     // staged side
    const int P = tl.P;
    const int side = PW + 2 * MARGIN;
    float* lv = smem;                    // the level below, rows of pitch P
    float* hz = smem + (size_t)side * P; // the horizontal pass, transposed
    // whether the staged region crosses the image border
    const bool edge = tl.oy < 0 || tl.ox < 0 || tl.oy + PW > a.H
                      || tl.ox + PW > a.W;

    for (int i = tid; i < MAX_LEVELS * (MAX_S + 1); i += NT)
        s_tap[i / (MAX_S + 1)][i % (MAX_S + 1)] =
            a.t[i / (MAX_S + 1)][i % (MAX_S + 1)];
    // stage level 0 of the group with clamped reads (edge replication):
    // a warp takes SR rows and 4 x 32 columns at a time, all SR x 4 loads
    // in flight before the first store
    constexpr int SR = 4;
    const float* s = a.src + (size_t)tl.p * (size_t)a.src_stride;
    const int warp = tid >> 5, lane = tid & 31;
    for (int r0 = warp; r0 < PW; r0 += SR * (NT / 32)) {
        for (int c0 = lane; c0 < PW; c0 += 4 * 32) {
            float v[SR][4];
#pragma unroll
            for (int i = 0; i < SR; ++i) {
                const int r = r0 + i * (NT / 32);
                const float* row =
                    s + (size_t)clampi(tl.oy + r, 0, a.H - 1) * a.W;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = c0 + 32 * j;
                    if (r < PW && c < PW)
                        v[i][j] = row[clampi(tl.ox + c, 0, a.W - 1)];
                }
            }
#pragma unroll
            for (int i = 0; i < SR; ++i) {
                const int r = r0 + i * (NT / 32);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = c0 + 32 * j;
                    if (r < PW && c < PW)
                        lv[(r + MARGIN) * P + c + MARGIN] = v[i][j];
                }
            }
        }
    }
    __syncthreads();

    int m_prev = a.Scum;                 // margin around the tile still valid
    for (int l = 0; l < a.n; ++l) {
        const int S = a.S[l];
        const int m = m_prev - S;
        const int mc = (m + RUN - 1) / RUN * RUN;
        // regions [lo_p, hi_p) of the level below and [lo, hi) of this one,
        // in staged coordinates, the same for rows and columns
        const int lo_p = a.Scum - m_prev, hi_p = a.Scum + a.T + m_prev;
        const int lo = a.Scum - m, hi = a.Scum + a.T + m;
        const bool keep = l + 1 < a.n;
        switch (S) {
#define PS_CASE(S_)                                                         \
    case S_:                                                                \
        level_step<S_>(a, tl, lv, hz, s_tap[l], l, lo_p, hi_p, lo, hi, mc,  \
                       keep);                                               \
        break;
            PS_CASE(0) PS_CASE(1) PS_CASE(2) PS_CASE(3) PS_CASE(4)
            PS_CASE(5) PS_CASE(6) PS_CASE(7) PS_CASE(8) PS_CASE(9)
            PS_CASE(10) PS_CASE(11) PS_CASE(12) PS_CASE(13) PS_CASE(14)
            PS_CASE(15) PS_CASE(16) PS_CASE(17) PS_CASE(18) PS_CASE(19)
            PS_CASE(20) PS_CASE(21) PS_CASE(22) PS_CASE(23) PS_CASE(24)
#undef PS_CASE
        }
        if (keep && edge) {
            // this level's own edge replication, for the next level's halo
            __syncthreads();
            const int n = hi - lo;
            for (int i = tid; i < n * n; i += NT) {
                const int r = lo + i / n, c = lo + i % n;
                const int rr = clampi(tl.oy + r, 0, a.H - 1) - tl.oy;
                const int cc = clampi(tl.ox + c, 0, a.W - 1) - tl.ox;
                if (rr != r || cc != c)
                    lv[(r + MARGIN) * P + c + MARGIN] =
                        lv[(rr + MARGIN) * P + cc + MARGIN];
            }
        }
        __syncthreads();
        m_prev = m;
    }
}

// Tile side for N planes of H x W and a cumulative halo Scum: the widest
// multiple of RUN up to MAX_T whose buffers let two blocks share an SM (or,
// if none does, that fit one block), narrowed while the launch would have
// fewer than WANT_TILES tiles, down to 16; 0 if none fits.
int tile_side(int N, int H, int W, int Scum) {
    int T = MAX_T;
    while (T >= RUN && smem_of(T, Scum) > SMEM_TWO) T -= RUN;
    if (T < RUN) {
        T = MAX_T;
        while (T >= RUN && smem_of(T, Scum) > SMEM_LIMIT) T -= RUN;
        if (T < RUN) return 0;
    }
    while (T > 16
           && (long long)((H + T - 1) / T) * ((W + T - 1) / T) * N
                  < WANT_TILES)
        T -= RUN;
    return T;
}

}  // namespace

// The tile side the launch takes for N planes of H x W and the cumulative
// halo Scum; 0 if its two staged buffers do not fit a block's shared memory.
extern "C" int ps_blur_chain_tile(int N, int H, int W, int Scum) {
    if (N < 1 || H < 1 || W < 1 || Scum < 0) return 0;
    return tile_side(N, H, W, Scum);
}

// src: N planes of H x W f32, `src_stride` floats apart. blur, dog: for each
// plane n levels of H x W, planes `*_stride` and levels `*_lstride` floats
// apart. taps: host array, level l's S[l] + 1 floats back to back;
// spans: host array of the n half-widths. pick: null, or N dense planes of
// OH x OW, `pick_stride` floats apart, that take every second pixel of level
// `pick_level` of the group (blur[2y, 2x]). T: the tile side
// (ps_blur_chain_tile gives the launch's own; any multiple of 8 whose
// buffers fit is taken).
extern "C" int ps_blur_chain(const float* src, long long src_stride,
                             float* blur, long long blur_stride,
                             long long blur_lstride, float* dog,
                             long long dog_stride, long long dog_lstride,
                             float* pick, long long pick_stride, int OH,
                             int OW, int pick_level, int N, int H, int W,
                             const float* taps, const int* spans, int n,
                             int T, void* stream) {
    if (n < 1 || n > MAX_LEVELS || N < 1 || H < 1 || W < 1 || N > 65535
        || T < RUN || T % RUN != 0)
        return (int)cudaErrorInvalidValue;
    if (pick != nullptr && (OH < 1 || OW < 1 || OH > (H + 1) / 2
                            || OW > (W + 1) / 2 || pick_level < 0
                            || pick_level >= n))
        return (int)cudaErrorInvalidValue;
    ChainArgs a = {};
    a.src = src;
    a.blur = blur;
    a.dog = dog;
    a.pick = pick;
    a.src_stride = src_stride;
    a.blur_stride = blur_stride;
    a.blur_lstride = blur_lstride;
    a.dog_stride = dog_stride;
    a.dog_lstride = dog_lstride;
    a.pick_stride = pick_stride;
    a.H = H;
    a.W = W;
    a.n = n;
    a.pick_level = pick == nullptr ? -1 : pick_level;
    a.OH = OH;
    a.OW = OW;
    int Scum = 0;
    for (int l = 0; l < n; ++l) {
        if (spans[l] < 0 || spans[l] > MAX_S)
            return (int)cudaErrorInvalidValue;
        a.S[l] = spans[l];
        for (int i = 0; i <= spans[l]; ++i) a.t[l][i] = *taps++;
        Scum += spans[l];
    }
    a.Scum = Scum;
    a.T = T;
    const size_t smem = smem_of(T, Scum);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        blur_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((W + a.T - 1) / a.T, (H + a.T - 1) / a.T, N);
    blur_chain_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
