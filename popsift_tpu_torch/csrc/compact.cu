// Candidate compaction: the candidate masks of all octaves and frames into
// capacity-padded candidate rows, with the counts kept on the device.
//
// Replaces: popsift_tpu/ops/extrema.py:_compact_mask (:195-282), which is XLA
// in the JAX package (no Pallas kernel), and the nonzero / cumsum /
// searchsorted walk of its plain PyTorch twin (ops/extrema.py::_compact_mask)
// that read every count back to the host.
//
// Semantics, entry for entry as _compact_mask on each (frame, octave)
// segment of N mask entries, B = 128, capacity cap, per-block clamp K:
//  * small masks (ceil(N/B) <= max(2 cap, 512)): every 128-entry block is a
//    row; a row keeps the first min(count, K) of its set entries;
//  * large masks: the rows are the blocks named by the same compaction one
//    level up, run on the bits "block is non-empty" with K = 127 (that level
//    may itself be large: the recursion goes on until a level is small),
//    and a row past the number of non-empty blocks is empty;
//  * entry s < cap is the s-th kept entry in row order; past the kept
//    entries (s >= sum of the clamped counts) it is the entry of rank
//    clamp(s - off[last], 0, K-1) of the last row, or lane 0 of that row when
//    the rank is past the row's clamped count; n_found = min(sum, cap) and
//    n_dropped = (set entries of the mask) - sum.
// So a run of 128 non-empty blocks loses its last block at level 2, and the
// row that would have held it takes the level-2 padding entry, exactly as in
// the plain version.
//
// Output: i32 rows x0, y0, z0 (z0 = layer + 1), frame-major: frame f's octave
// o owns rows [f * rows + row_off[o], ... + cap[o]), the layout K2's
// all-octave entry reads; i64 n_found[F, n_oct] and n_dropped[F, n_oct].
//
// What bounds it on the H100: bytes. The pass over the masks reads every
// mask byte once (33 MB for a 1080p frame); the rest is work proportional to
// the rows, a few thousand a segment.
//
// What the design does about it (two launches for every octave and frame):
//  1. compact_count_kernel: a warp walks 32 consecutive 128-entry blocks, one
//     coalesced 128-byte load a block (four in flight), and packs each block
//     into four 32-bit words of bits (level 1), the 32 blocks' "non-empty"
//     bits into one word (level 2) and their set-entry count into one int.
//     The masks are read once; what later levels read is 1/8 of it.
//  2. compact_select_kernel: one block of 1024 threads a segment. It sums the
//     counts, builds the bit words of levels 3.. where a mask needs them,
//     then walks the levels from the top down: a row per thread, the clamped
//     counts scanned across the block (shuffles, then one warp over the warp
//     totals), each row writing its kept entries at their offsets (a scatter
//     with no collisions), then the padding entries. Integer arithmetic
//     only: no atomics, the same result on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 128;               // entries a block (a row)
constexpr int MAX_OCT = 16;
constexpr int MAX_LEVELS = 4;        // levels of the recursion
constexpr int CHUNK = 32;            // blocks a warp in pass 1
constexpr int COUNT_WARPS = 8;       // warps a block in pass 1
constexpr int NT = 1024;             // threads a block in pass 2
constexpr int TOP_K = 127;           // K of every level above the first
constexpr unsigned FULL = 0xffffffffu;

struct Octave {
    const uint8_t* mask;             // u8[F, N], 0 or 1
    long long N;                     // entries a frame
    long long base;                  // scratch words of frame 0
    long long stride;                // scratch words a frame
    int HW, W;                       // plane size and width (x, y, z rows)
    int cap, K, row_off, levels;
    int nb1;                         // ceil(N / B)
    int off_ws, off_idx;             // scratch offsets within a frame (words)
    int off_bits[MAX_LEVELS];        // level l's bit words within a frame
    int chunk_end;                   // pass-1 items of octaves 0..o, all frames
};

struct Table {
    Octave o[MAX_OCT];
    int n;                           // octaves
    int rows;                        // output rows a frame
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Four mask bytes at entry pos .. pos+3 of a segment (0 past its end).
__device__ __forceinline__ uint32_t load4(const uint8_t* m, long long N,
                                          long long pos, bool aligned) {
    if (aligned && pos + 4 <= N)
        return *reinterpret_cast<const uint32_t*>(m + pos);
    uint32_t v = 0u;
    for (int i = 0; i < 4; ++i)
        if (pos + i < N) v |= (uint32_t)m[pos + i] << (8 * i);
    return v;
}

__device__ __forceinline__ uint32_t nibble(uint32_t v) {
    return ((v & 0xffu) != 0u ? 1u : 0u) | (((v >> 8) & 0xffu) != 0u ? 2u : 0u)
         | (((v >> 16) & 0xffu) != 0u ? 4u : 0u) | ((v >> 24) != 0u ? 8u : 0u);
}

__global__ void __launch_bounds__(COUNT_WARPS * 32)
compact_count_kernel(Table t, uint32_t* __restrict__ scratch) {
    const int lane = threadIdx.x & 31;
    int id = blockIdx.x * COUNT_WARPS + (threadIdx.x >> 5);
    if (id >= t.o[t.n - 1].chunk_end) return;        // uniform across the warp
    int o = 0;
    while (id >= t.o[o].chunk_end) ++o;
    if (o > 0) id -= t.o[o - 1].chunk_end;
    const Octave& q = t.o[o];
    const int n_chunks = (q.nb1 + CHUNK - 1) / CHUNK;
    const int f = id / n_chunks;
    const int c = id - f * n_chunks;
    const uint8_t* m = q.mask + (size_t)f * (size_t)q.N;
    uint32_t* fr = scratch + q.base + (size_t)f * (size_t)q.stride;
    uint32_t* bits1 = fr + q.off_bits[0];
    const bool aligned = ((uintptr_t)m & 3u) == 0u;
    uint32_t nonempty = 0u;
    int total = 0;
    for (int i0 = 0; i0 < CHUNK; i0 += 4) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            v[k] = load4(m, q.N, (long long)(c * CHUNK + i0 + k) * B + 4 * lane,
                         aligned);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // lane l holds entries 4l .. 4l+3: bits 4(l%8) .. of word l/8
            uint32_t w = nibble(v[k]) << (4 * (lane & 7));
            w |= __shfl_xor_sync(FULL, w, 1);
            w |= __shfl_xor_sync(FULL, w, 2);
            w |= __shfl_xor_sync(FULL, w, 4);
            int cnt = __popc(w);
            cnt += __shfl_xor_sync(FULL, cnt, 8);
            cnt += __shfl_xor_sync(FULL, cnt, 16);
            const int blk = c * CHUNK + i0 + k;
            if (blk < q.nb1 && (lane & 7) == 0) bits1[4 * blk + (lane >> 3)] = w;
            nonempty |= (cnt > 0 ? 1u : 0u) << (i0 + k);
            total += cnt;
        }
    }
    if (lane == 0) {
        fr[q.off_bits[1] + c] = nonempty;
        reinterpret_cast<int*>(fr + q.off_ws)[c] = total;
    }
}

// Exclusive scan of one int a thread across the block; `total` gets the sum.
__device__ int block_scan(int v, int& total) {
    __shared__ int warp_sum[NT / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = warp_sum[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, w, d);
            if (lane >= d) w += y;
        }
        warp_sum[lane] = w;
    }
    __syncthreads();
    total = warp_sum[NT / 32 - 1];
    const int excl = x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
    __syncthreads();                                  // warp_sum is reused
    return excl;
}

// The four words of 128-bit group g of a level's bits (0 past its words).
__device__ __forceinline__ void group(const uint32_t* bits, int n_words, int g,
                                      uint32_t (&rb)[4]) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
        const int i = 4 * g + w;
        rb[w] = i < n_words ? bits[i] : 0u;
    }
}

__device__ __forceinline__ int popc4(const uint32_t (&rb)[4]) {
    return __popc(rb[0]) + __popc(rb[1]) + __popc(rb[2]) + __popc(rb[3]);
}

// Lane of the set bit of rank j (0-based) of a group that has more than j.
__device__ int lane_of_rank(const uint32_t (&rb)[4], int j) {
    for (int w = 0; w < 4; ++w) {
        uint32_t x = rb[w];
        const int c = __popc(x);
        if (j < c) {
            for (int i = 0; i < j; ++i) x &= x - 1u;
            return 32 * w + __ffs((int)x) - 1;
        }
        j -= c;
    }
    return 0;
}

__global__ void __launch_bounds__(NT)
compact_select_kernel(Table t, uint32_t* scratch, int* __restrict__ x0,
                      int* __restrict__ y0, int* __restrict__ z0,
                      long long* __restrict__ n_found,
                      long long* __restrict__ n_dropped) {
    __shared__ int s_count[MAX_LEVELS + 1];
    __shared__ int s_last[3];                // the last row: id, count, offset
    __shared__ uint32_t s_last_bits[4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int f = blockIdx.x / t.n;
    const int o = blockIdx.x - f * t.n;
    const Octave& q = t.o[o];
    uint32_t* fr = scratch + q.base + (size_t)f * (size_t)q.stride;
    const int D = q.levels, cap = q.cap;

    // bit counts and words of each level: level 0 is the mask, level l+1
    // the "non-empty" bits of level l's 128-bit groups
    long long n[MAX_LEVELS];
    int n_words[MAX_LEVELS];
    n[0] = q.N;
    for (int l = 1; l < MAX_LEVELS; ++l) n[l] = (n[l - 1] + B - 1) / B;
    n_words[0] = 4 * q.nb1;
    n_words[1] = (q.nb1 + CHUNK - 1) / CHUNK;
    for (int l = 2; l < MAX_LEVELS; ++l) n_words[l] = (int)((n[l] + 31) / 32);

    // set entries of the mask, and of level 1 (the non-empty blocks)
    {
        const int* ws = reinterpret_cast<const int*>(fr + q.off_ws);
        const uint32_t* b1 = fr + q.off_bits[1];
        int bits = 0, ne = 0;
        for (int i = tid; i < n_words[1]; i += NT) {
            bits += ws[i];
            ne += __popc(b1[i]);
        }
        int tot;
        block_scan(bits, tot);
        if (tid == 0) s_count[0] = tot;
        block_scan(ne, tot);
        if (tid == 0) s_count[1] = tot;
    }
    // levels 2 .. D-1: the bits of level l from the groups of level l-1
    for (int l = 2; l < D; ++l) {
        const uint32_t* src = fr + q.off_bits[l - 1];
        uint32_t* dst = fr + q.off_bits[l];
        int ne = 0;
        for (int g0 = 0; g0 < n[l]; g0 += NT) {
            const int g = g0 + tid;
            bool any = false;
            if (g < n[l]) {
                uint32_t rb[4];
                group(src, n_words[l - 1], g, rb);
                any = (rb[0] | rb[1] | rb[2] | rb[3]) != 0u;
            }
            const unsigned word = __ballot_sync(FULL, any);
            const int g_word = g0 + warp * 32;
            if (lane == 0 && g_word < n[l]) dst[g_word / 32] = word;
            ne += any ? 1 : 0;
        }
        int tot;
        block_scan(ne, tot);
        if (tid == 0) s_count[l] = tot;
        __syncthreads();                          // dst complete for level l-1
    }
    __syncthreads();

    // the levels from the top down; level l's rows are level l+1's entries
    int* idx_in = reinterpret_cast<int*>(fr + q.off_idx);
    int* idx_out = idx_in + cap;
    const long long out0 = (long long)f * t.rows + q.row_off;
    for (int l = D - 1; l >= 0; --l) {
        const bool small = l == D - 1;
        const int K = l == 0 ? q.K : TOP_K;
        const int n_rows = small ? (int)((n[l] + B - 1) / B) : cap;
        const int live_rows = small ? n_rows : imin(cap, s_count[l + 1]);
        const uint32_t* bits = fr + q.off_bits[l];
        auto emit = [&](int s, int entry) {
            if (l == 0) {
                const long long r = out0 + s;
                x0[r] = entry % q.W;
                y0[r] = (entry % q.HW) / q.W;
                z0[r] = entry / q.HW + 1;
            } else {
                idx_out[s] = entry;
            }
        };
        int carry = 0;
        for (int r0 = 0; r0 < n_rows; r0 += NT) {
            const int r = r0 + tid;
            int id = 0, cnt = 0;
            uint32_t rb[4] = {0u, 0u, 0u, 0u};
            if (r < n_rows) {
                id = small ? r : idx_in[r];
                if (r < live_rows) group(bits, n_words[l], id, rb);
                cnt = imin(popc4(rb), K);
            }
            int tot;
            const int off = block_scan(cnt, tot) + carry;
            // this row's kept entries, in lane order, at off, off+1, ...
            int s = off;
            for (int w = 0; w < 4 && s < off + cnt && s < cap; ++w) {
                uint32_t x = rb[w];
                while (x != 0u && s < off + cnt && s < cap) {
                    emit(s++, id * B + 32 * w + __ffs((int)x) - 1);
                    x &= x - 1u;
                }
            }
            if (r == n_rows - 1) {
                s_last[0] = id;
                s_last[1] = cnt;
                s_last[2] = off;
                for (int w = 0; w < 4; ++w) s_last_bits[w] = rb[w];
            }
            carry += tot;
        }
        __syncthreads();
        // padding entries past the kept ones: the last row's entry of rank
        // clamp(s - off, 0, K-1), or its lane 0
        uint32_t lb[4];
        for (int w = 0; w < 4; ++w) lb[w] = s_last_bits[w];
        for (int s = carry + tid; s < cap; s += NT) {
            const int j = imin(imax(s - s_last[2], 0), K - 1);
            emit(s, s_last[0] * B + (j < s_last[1] ? lane_of_rank(lb, j) : 0));
        }
        if (l == 0 && tid == 0) {
            n_found[blockIdx.x] = imin(carry, cap);
            n_dropped[blockIdx.x] = (long long)s_count[0] - carry;
        }
        __syncthreads();
        int* tmp = idx_in;
        idx_in = idx_out;
        idx_out = tmp;
    }
}

}  // namespace

// Compaction of n_oct octaves' masks of F frames. `table` is a host array
// i64[n_oct, 16]: mask address (u8[F, N]), N, H*W, W, cap, K, first output
// row of the octave in a frame, levels, scratch base (words), scratch words a
// frame, then the offsets within a frame of the counts, the level-1 indices
// (2 cap ints) and the bits of levels 0..3. `rows` is the output rows a
// frame; x0, y0, z0 are i32[F * rows], n_found and n_dropped i64[F, n_oct].
extern "C" int ps_compact_octaves(const long long* table, int n_oct, int F,
                                  int rows, void* scratch, int* x0, int* y0,
                                  int* z0, long long* n_found,
                                  long long* n_dropped, void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT || F < 1) return (int)cudaErrorInvalidValue;
    Table t = {};
    t.n = n_oct;
    t.rows = rows;
    long long items = 0;
    for (int o = 0; o < n_oct; ++o) {
        const long long* r = table + 16 * o;
        Octave& q = t.o[o];
        q.mask = (const uint8_t*)(uintptr_t)r[0];
        q.N = r[1];
        q.HW = (int)r[2];
        q.W = (int)r[3];
        q.cap = (int)r[4];
        q.K = (int)r[5];
        q.row_off = (int)r[6];
        q.levels = (int)r[7];
        q.base = r[8];
        q.stride = r[9];
        q.off_ws = (int)r[10];
        q.off_idx = (int)r[11];
        for (int l = 0; l < MAX_LEVELS; ++l) q.off_bits[l] = (int)r[12 + l];
        if (q.N < 1 || q.N > 0x7fffffffLL || q.cap < 1 || q.K < 1 || q.K > TOP_K
            || q.levels < 1 || q.levels > MAX_LEVELS || q.W < 1 || q.HW < 1)
            return (int)cudaErrorInvalidValue;
        q.nb1 = (int)((q.N + B - 1) / B);
        items += (long long)F * ((q.nb1 + CHUNK - 1) / CHUNK);
        if (items > 0x7fffffffLL - COUNT_WARPS)
            return (int)cudaErrorInvalidValue;
        q.chunk_end = (int)items;
    }
    cudaStream_t s = (cudaStream_t)stream;
    uint32_t* scr = (uint32_t*)scratch;
    const int grid = (int)((items + COUNT_WARPS - 1) / COUNT_WARPS);
    compact_count_kernel<<<grid, COUNT_WARPS * 32, 0, s>>>(t, scr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    compact_select_kernel<<<F * n_oct, NT, 0, s>>>(t, scr, x0, y0, z0, n_found,
                                                   n_dropped);
    return (int)cudaGetLastError();
}
