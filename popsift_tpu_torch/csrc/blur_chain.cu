// K7: fused chain of blur levels and their DoGs for one group of levels.
//
// Replaces: popsift_tpu/ops/pallas/blur.py:octave_blur_chain (the Pallas call
// in _octave_chain_call at :279), the opt-in front that computes levels
// 1..L-1 of an octave and their DoGs from level 0, in groups of `group`
// levels.
//
// What bounds it on the H100: memory against recomputation. Level by level
// (K5) every level is written and read back: 12 bytes a pixel a level. Fused,
// a group of n levels reads its first input once and writes n blurs and n
// DoGs: 4 + 8n bytes a pixel, but a tile must stage the cumulative halo
// Scum = sum of the group's half-widths on every side and recompute the
// shrinking halo region at every level.
//
// What the design does about it: one block computes one T x T output tile of
// every level of the group for one plane (grid z = plane, so all frames of a
// batch go in one launch). It stages the input tile plus Scum pixels a side in
// shared memory once, with clamped reads (edge replication). For each level it
// runs the horizontal pass and then the vertical pass over the region whose
// halo is still valid (the region shrinks by that level's half-width S), then
// re-replicates the level's own border: every staged position whose image
// coordinate falls outside the image takes the level's value at the clamped
// coordinate, which the same tile always holds. Without that, levels >= 2
// would see "the blur of replicated level 0" in the halo instead of "the
// replicated blur" (blur.py:230-252). Then it writes the level's tile and its
// DoG and goes on from shared memory. Three shared buffers (previous level,
// horizontal pass, current level) of (T + 2 Scum)^2 floats each; the host
// picks the largest T of 64, 32, 16 that fits the 227 KB a block may use.
//
// Arithmetic is K5's (blur_dog.cu), term for term: horizontal before vertical,
// the centre tap first, then acc = acc + (left + right) * tap[off] outward,
// one rounding per operation (-fmad=false), the DoG a separate subtraction.
// So every level equals K5's, and the plain version's, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;         // thread columns of a block (one warp)
constexpr int TY = 32;         // thread rows
constexpr int NT = TX * TY;    // threads of a block
constexpr int MAX_S = 24;      // widest half-filter taken
constexpr int MAX_LEVELS = 5;  // most levels of one group
// dynamic shared memory a block may ask for: the 227 KB of an SM less 1 KB
// for the kernel's static arrays
constexpr size_t SMEM_LIMIT = 226 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

struct ChainTaps {
    int n;                          // levels in the group
    int S[MAX_LEVELS];              // half-width per level
    float t[MAX_LEVELS][MAX_S + 1]; // t[l][0] centre, t[l][off] pair at +-off
};

__global__ void __launch_bounds__(NT)
blur_chain_kernel(const float* __restrict__ src, long long src_stride,
                  float* __restrict__ blur, long long blur_stride,
                  long long blur_lstride, float* __restrict__ dog,
                  long long dog_stride, long long dog_lstride, int H, int W,
                  int T, int Scum, ChainTaps taps) {
    extern __shared__ float smem[];
    __shared__ float s_tap[MAX_LEVELS][MAX_S + 1];
    const int PW = T + 2 * Scum;          // staged side (rows and columns)
    float* prev = smem;                   // [PW][PW] level l-1
    float* hz = smem + PW * PW;           // [PW][PW] horizontal pass
    float* cur = smem + 2 * PW * PW;      // [PW][PW] level l
    const int p = blockIdx.z;
    const int oy = blockIdx.y * T - Scum; // image row of staged row 0
    const int ox = blockIdx.x * T - Scum;
    const int tx = threadIdx.x;           // walks columns
    const int ty = threadIdx.y;           // walks rows

    if (ty < taps.n && tx <= MAX_S) s_tap[ty][tx] = taps.t[ty][tx];
    const float* s = src + (size_t)p * (size_t)src_stride;
    for (int r = ty; r < PW; r += TY) {
        const float* row = s + (size_t)clampi(oy + r, 0, H - 1) * W;
        for (int c = tx; c < PW; c += TX)
            prev[r * PW + c] = row[clampi(ox + c, 0, W - 1)];
    }
    __syncthreads();

    int m_prev = Scum;                    // margin around the tile still valid
    for (int l = 0; l < taps.n; ++l) {
        const int S = taps.S[l];
        const float* tap = s_tap[l];
        const int m = m_prev - S;
        // regions [lo_p, hi_p) of the previous level and [lo, hi) of this
        // one, in staged coordinates, the same for rows and columns
        const int lo_p = Scum - m_prev, hi_p = Scum + T + m_prev;
        const int lo = Scum - m, hi = Scum + T + m;

        // horizontal pass: rows of the previous region, columns of this one
        for (int r = lo_p + ty; r < hi_p; r += TY) {
            for (int c = lo + tx; c < hi; c += TX) {
                const float* row = prev + r * PW + c;
                float acc = row[0] * tap[0];
                for (int off = 1; off <= S; ++off)
                    acc = acc + (row[-off] + row[off]) * tap[off];
                hz[r * PW + c] = acc;
            }
        }
        __syncthreads();
        // vertical pass over this level's region
        for (int r = lo + ty; r < hi; r += TY) {
            for (int c = lo + tx; c < hi; c += TX) {
                const float* col = hz + r * PW + c;
                float acc = col[0] * tap[0];
                for (int off = 1; off <= S; ++off)
                    acc = acc + (col[-off * PW] + col[off * PW]) * tap[off];
                cur[r * PW + c] = acc;
            }
        }
        __syncthreads();
        // this level's own edge replication, for the next level's halo
        if (l + 1 < taps.n) {
            for (int r = lo + ty; r < hi; r += TY) {
                const int rr = clampi(oy + r, 0, H - 1) - oy;
                for (int c = lo + tx; c < hi; c += TX) {
                    const int cc = clampi(ox + c, 0, W - 1) - ox;
                    if (rr != r || cc != c)
                        cur[r * PW + c] = cur[rr * PW + cc];
                }
            }
        }
        // the tile: blur_l and DoG = blur_l - blur_{l-1}
        float* b = blur + (size_t)p * (size_t)blur_stride
                   + (size_t)l * (size_t)blur_lstride;
        float* d = dog + (size_t)p * (size_t)dog_stride
                   + (size_t)l * (size_t)dog_lstride;
        for (int r = Scum + ty; r < Scum + T; r += TY) {
            const int y = oy + r;
            for (int c = Scum + tx; c < Scum + T; c += TX) {
                const int x = ox + c;
                if (y < H && x < W) {
                    const float v = cur[r * PW + c];
                    const size_t o = (size_t)y * W + x;
                    b[o] = v;
                    d[o] = v - prev[r * PW + c];
                }
            }
        }
        __syncthreads();
        float* tmp = prev;
        prev = cur;
        cur = tmp;
        m_prev = m;
    }
}

}  // namespace

// Largest tile side whose three staged buffers fit a block's shared memory,
// not larger than needed for an H x W plane; 0 if none fits.
extern "C" int ps_blur_chain_tile(int H, int W, int Scum) {
    int T = 0;
    for (int cand = 64; cand >= 16 && T == 0; cand /= 2) {
        const size_t side = (size_t)cand + 2 * (size_t)Scum;
        if (3 * side * side * sizeof(float) <= SMEM_LIMIT) T = cand;
    }
    const int need = H > W ? H : W;
    while (T > 16 && T / 2 >= need) T /= 2;
    return T;
}

// src: N planes of H x W f32, `src_stride` floats apart. blur, dog: for each
// plane n levels of H x W, planes `*_stride` and levels `*_lstride` floats
// apart. taps: host array, level l's S[l] + 1 floats back to back;
// spans: host array of the n half-widths.
extern "C" int ps_blur_chain(const float* src, long long src_stride,
                             float* blur, long long blur_stride,
                             long long blur_lstride, float* dog,
                             long long dog_stride, long long dog_lstride,
                             int N, int H, int W, const float* taps,
                             const int* spans, int n, void* stream) {
    if (n < 1 || n > MAX_LEVELS || N < 1 || H < 1 || W < 1 || N > 65535)
        return (int)cudaErrorInvalidValue;
    ChainTaps t = {};
    t.n = n;
    int Scum = 0;
    for (int l = 0; l < n; ++l) {
        if (spans[l] < 0 || spans[l] > MAX_S)
            return (int)cudaErrorInvalidValue;
        t.S[l] = spans[l];
        for (int i = 0; i <= spans[l]; ++i) t.t[l][i] = *taps++;
        Scum += spans[l];
    }
    const int T = ps_blur_chain_tile(H, W, Scum);
    if (T == 0) return (int)cudaErrorInvalidValue;
    const size_t side = (size_t)T + 2 * (size_t)Scum;
    const size_t smem = 3 * side * side * sizeof(float);
    cudaError_t rc = cudaFuncSetAttribute(
        blur_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    const dim3 grid((W + T - 1) / T, (H + T - 1) / T, N);
    blur_chain_kernel<<<grid, dim3(TX, TY), smem, (cudaStream_t)stream>>>(
        src, src_stride, blur, blur_stride, blur_lstride, dog, dog_stride,
        dog_lstride, H, W, T, Scum, t);
    return (int)cudaGetLastError();
}
