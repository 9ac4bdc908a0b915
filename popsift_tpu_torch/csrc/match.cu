// The exact matcher's distance product and top-2 selection in one kernel.
//
// Replaces no Pallas kernel: the JAX package computes the matcher in XLA
// (popsift_tpu/ops/matching.py:36, one f32 product a tile at
// Precision.HIGHEST, then argmin, mask, argmin and a stable argsort merge),
// and the port's plain version (ops/kernels/match.py::match_top2_torch)
// does the same in torch. That plain path writes the f32 distance field of
// every tile of right rows to device memory and reads it back about six
// times, when two floats and two indices a left row are wanted. This kernel
// keeps the field in registers.
//
// Semantics, for every left row i over every right row j of the padded sets:
//   d2[i, j] = (|l_i|^2 + |r_j|^2) - 2 * (l_i . r_j), +inf where valid_r[j]
//   is false; the row's (best, best_idx, second, second_idx) is the least
//   and second least (distance, column) in lexicographic order, the carry
//   starting at (+inf, 0), (+inf, 0).
// Among equal distances the lower column wins, and no +inf entry displaces
// the carry, so these are the indices the plain path's "first minimal
// column, mask it, first minimal column again, stable merge" rule gives,
// where a distance is +inf too (a row with one finite candidate keeps the
// carry's column 0 as second_idx). The dot products and the squared norms
// are the same chain of fused multiply-adds over k = 0..127, so an exact
// duplicate reads 0 exactly. Every product is a full f32 FFMA on the CUDA
// cores: no TF32, bf16 or split-float tensor-core product.
//
// What bounds it on the H100: f32 operations. The matcher's bound
// (benchmark harness/bounds.py::match_bound) is 2 x 128 operations a
// (left, right) pair of the padded sets, 222 GFLOP at 29,450 rows a side, or
// 3.31 ms at 67 TFLOP/s; its bytes (the two sets, 30 MB, or the field's
// 3.5 GB were it written) are far below.
//
// What the design does about it:
//  * A first small launch takes each row's squared norm (+inf for a right
//    row that is not valid, which makes its d2 +inf) and writes both sets
//    k-major, each padded to a multiple of 128 rows by repeating its last
//    row, so that a tile is 128 contiguous 512-byte k rows.
//  * A block keeps its 128 left rows resident in shared memory, k-major
//    (128 floats a k row, padded to 132), and walks its share of the right
//    set in tiles of 128 rows, double-buffered with cp.async: the next
//    tile's copy is in flight while the current one is multiplied. 256
//    threads, each an 8 x 8 register tile of (left, right) pairs, rows
//    4 tr .. 4 tr + 3 and 64 more, columns 4 tc .. 4 tc + 3 and 64 more, so
//    a warp's loads at one k are 64 contiguous bytes of left rows and 128
//    of right rows: 4 loads of 16 bytes feed 64 FFMA.
//  * The epilogue of a tile forms each pair's d2 in registers, one FFMA on
//    lsq + rsq, and folds a row's 8 into the thread's running pair of that
//    row when their minimum beats its second; a thread sees its columns in
//    increasing order, so a strict "<" is the lexicographic rule. The field
//    never reaches memory.
//  * The 16 threads of a row merge their pairs by the lexicographic rule
//    (three shuffles in a warp, one exchange through shared memory across
//    the two warps), and the block writes one (best, second) a row and part.
//  * The right set is split into S contiguous parts (the grid's y), S
//    chosen by the wrapper so that the blocks fill whole waves of the SMs
//    (231 blocks of left rows at 29,450 rows leave 33 SMs idle in a second
//    wave; 4 parts make 924 blocks, 7 waves of 132). A last small launch
//    merges the S parts of each row in order. The lexicographic top 2 of a
//    set does not depend on the order of the merges, and no atomic decides
//    anything: three calls give the same bits.
// Every padded row pair is computed; rows past L or R in a ragged last tile
// repeat the last row and are masked (+inf, never written).

#include <cuda_runtime.h>
#include <cuda_pipeline_primitives.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // descriptor width
constexpr int BM = 128;         // left rows a block
constexpr int BN = 128;         // right rows a tile
constexpr int LDS = BM + 4;     // shared stride of a k row, in floats
constexpr int NT = 256;         // threads a block: 16 x 16, 8 x 8 pairs each
constexpr int TM = 8;
constexpr int SMEM_BYTES = 3 * D * LDS * (int)sizeof(float);

__device__ __forceinline__ bool lex_less(float d1, int i1, float d2, int i2) {
    return d1 < d2 || (d1 == d2 && i1 < i2);
}

// (b, bi) <= (s, si) and (b2, bi2) <= (s2, si2): the least two of the four
__device__ __forceinline__ void merge2(float& b, int& bi, float& s, int& si,
                                       float b2, int bi2, float s2, int si2) {
    if (lex_less(b2, bi2, b, bi)) {
        if (lex_less(s2, si2, b, bi)) {
            s = s2;
            si = si2;
        } else {
            s = b;
            si = bi;
        }
        b = b2;
        bi = bi2;
    } else if (lex_less(b2, bi2, s, si)) {
        s = b2;
        si = bi2;
    }
}

// one row a thread, left rows then right rows, each set padded to a
// multiple of 128 rows (a padding row repeats the last row): the row's
// squared norm, as the product kernel's chain (fma over k), and the row
// written k-major (xT[k][row], stride the padded count)
__global__ void __launch_bounds__(256)
prep_kernel(const float* __restrict__ dl, int L, int Lp,
            const float* __restrict__ dr, const unsigned char* __restrict__ vr,
            int R, int Rp, float* __restrict__ norms, float* __restrict__ lT,
            float* __restrict__ rT) {
    const int row = blockIdx.x * 256 + threadIdx.x;
    if (row >= Lp + Rp) return;
    const bool left = row < Lp;
    const int i = left ? row : row - Lp;
    const int n = left ? L : R;
    const int stride = left ? Lp : Rp;
    const float* x = (left ? dl : dr) + (size_t)min(i, n - 1) * D;
    float* xT = (left ? lT : rT) + i;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) {
        const float v = x[k];
        acc = fmaf(v, v, acc);
        xT[(size_t)k * stride] = v;
    }
    if (i < n) norms[left ? i : L + i] = (left || vr[i]) ? acc : INFINITY;
}

// 16-byte copies of columns [c0, c0 + 128) of every k row of a k-major set
// (stride floats a k row) into a shared tile [D][LDS]
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ xT,
                                          int c0, int stride) {
    #pragma unroll
    for (int i = 0; i < D * (BM / 4) / NT; ++i) {
        const int c = threadIdx.x + NT * i;
        const int k = c / (BM / 4);
        const int q = c % (BM / 4);
        __pipeline_memcpy_async(dst + k * LDS + 4 * q,
                                xT + (size_t)k * stride + c0 + 4 * q, 16);
    }
}

// row m (0..7) of thread tr: rows 4 tr .. 4 tr + 3, then 64 more
__device__ __forceinline__ int sub(int t, int m) {
    return (m < 4 ? 0 : 64 - 4) + 4 * t + m;
}

// block (x, y): left rows [128 x, 128 x + 128) against right part y of S;
// writes (best, second) a row to part[y] (distances in pd, columns in pi)
__global__ void __launch_bounds__(NT, 1)
top2_kernel(const float* __restrict__ lT, int L, int Lp,
            const float* __restrict__ rT, int R, int Rp,
            const float* __restrict__ norms, int S, float* __restrict__ pd,
            int* __restrict__ pi) {
    extern __shared__ float4 match_smem[];
    float* As = reinterpret_cast<float*>(match_smem);
    float* Bs = As + D * LDS;
    const float* rnorm = norms + L;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tr = (warp / 2) * 4 + lane / 8;     // 0..15
    const int tc = (warp % 2) * 8 + lane % 8;     // 0..15
    const int l0 = blockIdx.x * BM;
    const int T = Rp / BN;
    const int p = blockIdx.y;
    const int t0 = (int)((long long)p * T / S);
    const int t1 = (int)((long long)(p + 1) * T / S);

    float lsq[TM];
    #pragma unroll
    for (int m = 0; m < TM; ++m) lsq[m] = norms[min(l0 + sub(tr, m), L - 1)];
    float b[TM], s[TM];
    int bi[TM], si[TM];
    #pragma unroll
    for (int m = 0; m < TM; ++m) {
        b[m] = INFINITY;
        s[m] = INFINITY;
        bi[m] = 0;
        si[m] = 0;
    }

    load_tile(As, lT, l0, Lp);
    if (t0 < t1) load_tile(Bs, rT, t0 * BN, Rp);
    __pipeline_commit();
    for (int t = t0; t < t1; ++t) {
        const float* Bt = Bs + ((t - t0) & 1) * D * LDS;
        if (t + 1 < t1)
            load_tile(Bs + ((t - t0 + 1) & 1) * D * LDS, rT, (t + 1) * BN, Rp);
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();

        float acc[TM][TM];
        #pragma unroll
        for (int m = 0; m < TM; ++m)
            #pragma unroll
            for (int n = 0; n < TM; ++n) acc[m][n] = 0.f;
        #pragma unroll 4
        for (int k = 0; k < D; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDS + 4 * tr);
            const float4 a1 = *reinterpret_cast<const float4*>(As + k * LDS + 64 + 4 * tr);
            const float4 b0 = *reinterpret_cast<const float4*>(Bt + k * LDS + 4 * tc);
            const float4 b1 = *reinterpret_cast<const float4*>(Bt + k * LDS + 64 + 4 * tc);
            const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float r[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            #pragma unroll
            for (int m = 0; m < TM; ++m)
                #pragma unroll
                for (int n = 0; n < TM; ++n) acc[m][n] = fmaf(a[m], r[n], acc[m][n]);
        }

        float rsq[TM];
        #pragma unroll
        for (int n = 0; n < TM; ++n) {
            const int col = t * BN + sub(tc, n);
            rsq[n] = col < R ? rnorm[col] : INFINITY;
        }
        #pragma unroll
        for (int m = 0; m < TM; ++m) {
            // (lsq + rsq) - 2 dot in one rounding: 2 dot is exact, so the
            // fused form is the plain path's formula bit for bit
            float d[TM];
            #pragma unroll
            for (int n = 0; n < TM; ++n)
                d[n] = fmaf(-2.f, acc[m][n], lsq[m] + rsq[n]);
            float lo = d[0];
            #pragma unroll
            for (int n = 1; n < TM; ++n) lo = fminf(lo, d[n]);
            if (lo < s[m]) {
                #pragma unroll
                for (int n = 0; n < TM; ++n) {
                    if (d[n] < s[m]) {
                        const int col = t * BN + sub(tc, n);
                        if (d[n] < b[m]) {
                            s[m] = b[m];
                            si[m] = bi[m];
                            b[m] = d[n];
                            bi[m] = col;
                        } else {
                            s[m] = d[n];
                            si[m] = col;
                        }
                    }
                }
            }
        }
        __syncthreads();
    }
    __pipeline_wait_prior(0);

    // the 8 threads of a row in this warp, then the other warp's 8
    #pragma unroll
    for (int m = 0; m < TM; ++m)
        #pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
            const float b2 = __shfl_xor_sync(0xffffffffu, b[m], o);
            const int bi2 = __shfl_xor_sync(0xffffffffu, bi[m], o);
            const float s2 = __shfl_xor_sync(0xffffffffu, s[m], o);
            const int si2 = __shfl_xor_sync(0xffffffffu, si[m], o);
            merge2(b[m], bi[m], s[m], si[m], b2, bi2, s2, si2);
        }
    __syncthreads();
    float* xd = Bs;                                   // [BM][2]
    int* xi = reinterpret_cast<int*>(Bs + 2 * BM);    // [BM][2]
    if (warp % 2 == 1 && lane % 8 == 0)
        #pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int row = sub(tr, m);
            xd[2 * row] = b[m];
            xd[2 * row + 1] = s[m];
            xi[2 * row] = bi[m];
            xi[2 * row + 1] = si[m];
        }
    __syncthreads();
    if (warp % 2 == 0 && lane % 8 == 0)
        #pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int row = sub(tr, m);
            merge2(b[m], bi[m], s[m], si[m], xd[2 * row], xi[2 * row],
                   xd[2 * row + 1], xi[2 * row + 1]);
            const int i = l0 + row;
            if (i < L) {
                const size_t o = 2 * ((size_t)p * L + i);
                pd[o] = b[m];
                pd[o + 1] = s[m];
                pi[o] = bi[m];
                pi[o + 1] = si[m];
            }
        }
}

// row i: the S parts' pairs merged in part order
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ pd, const int* __restrict__ pi, int L,
             int S, float* __restrict__ best_d, long long* __restrict__ best_i,
             float* __restrict__ second_d, long long* __restrict__ second_i) {
    const int i = blockIdx.x * 256 + threadIdx.x;
    if (i >= L) return;
    float b = pd[2 * (size_t)i], s = pd[2 * (size_t)i + 1];
    int bi = pi[2 * (size_t)i], si = pi[2 * (size_t)i + 1];
    for (int p = 1; p < S; ++p) {
        const size_t o = 2 * ((size_t)p * L + i);
        merge2(b, bi, s, si, pd[o], pi[o], pd[o + 1], pi[o + 1]);
    }
    best_d[i] = b;
    best_i[i] = bi;
    second_d[i] = s;
    second_i[i] = si;
}

}  // namespace

// dl f32[L, 128], dr f32[R, 128], vr u8[R]; scratch f32[128 (Lp + Rp) + L
// + R + 4 S L], Lp and Rp the counts padded to multiples of 128: the two
// sets k-major, the norms, then each part's (best, second) distances and
// columns; outputs f32[L] / i64[L]. L, R >= 1, 1 <= S <= Rp / 128.
extern "C" int ps_match_top2(const float* dl, int L, const float* dr,
                             const unsigned char* vr, int R, int S,
                             float* scratch, float* best_d, long long* best_i,
                             float* second_d, long long* second_i,
                             void* stream) {
    const int Lp = (L + BM - 1) / BM * BM, Rp = (R + BN - 1) / BN * BN;
    if (L < 1 || R < 1 || S < 1 || S > Rp / BN)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    float* lT = scratch;
    float* rT = lT + (size_t)D * Lp;
    float* norms = rT + (size_t)D * Rp;
    float* pd = norms + (size_t)L + R;
    int* pi = reinterpret_cast<int*>(pd + 2 * (size_t)S * L);
    prep_kernel<<<(Lp + Rp + 255) / 256, 256, 0, st>>>(dl, L, Lp, dr, vr, R,
                                                       Rp, norms, lT, rT);
    cudaError_t err = cudaFuncSetAttribute(
        top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(Lp / BM, S);
    top2_kernel<<<grid, NT, SMEM_BYTES, st>>>(lT, L, Lp, rT, R, Rp, norms, S,
                                              pd, pi);
    merge_kernel<<<(L + 255) / 256, 256, 0, st>>>(pd, pi, L, S, best_d, best_i,
                                                  second_d, second_i);
    return (int)cudaGetLastError();
}
