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
// What bounds it on the H100: bytes for the count, latency for the select.
// The count reads every mask byte once (33 MB for a 1080p frame). The
// select's work is proportional to the rows, a few thousand a segment, but
// it runs in one block after its segment's count, as a chain of dependent
// steps (the recursion's levels, each a load from L2 and a scan), and one
// SM writes its segment's output rows (12 bytes a row, cap rows).
//
// What the design does about it (one launch for every octave and frame):
//  * The count: a warp walks 2 x 32 consecutive 128-entry blocks, eight
//    16-byte loads a lane for each 32 in flight before the first is used,
//    and packs each block into four 32-bit words of bits (level 1) and the
//    32 blocks' "non-empty" bits into one word (level 2). The masks are read
//    once; what later levels read is 1/8 of it. A launch block (32 warps)
//    adds its set entries and its non-empty blocks to its segment's totals
//    with integer atomics.
//  * The padding rows: the entry every row past the kept ones takes is
//    lane 0 of the last row of each level, unless a level's last row keeps
//    K entries or the level above fills it. Each count block writes its
//    share of its segment's output rows as that entry (pad_guess, made on
//    the host), so that the rows are written by many SMs at once; the
//    select writes the kept rows over them, or every row where the padding
//    turns out to be another entry.
//  * The select runs in the launch block that finishes its segment last:
//    each block takes a ticket (an integer atomicAdd on the segment's
//    counter, after a fence), and the one with the last ticket walks the
//    levels from the top down. No block waits for another, so the launch
//    cannot hang, also where blocks run one after another.
//  * The select is wide and short: a step takes up to 4096 rows, row k by
//    thread k % 1024 (a run of dense rows spreads over a warp's lanes,
//    whose entries are written one after another), one 16-byte load a row
//    for its four words and one scan across the block for their offsets.
//    Where the rows are the mask's blocks, their "non-empty" bits are read
//    first and only the non-empty blocks, in order, take steps; a lower
//    level's rows are the live ones the level above named. A level's
//    entries are flat indices in shared memory where the capacity fits
//    (else in the scratch); level 0's become (x, y, layer + 1) rows, four a
//    16-byte store, each division a multiply-high by a constant made on
//    the host.
//  * Measured on the 1080p frame (PERF.md, an H100): the count streams at
//    about 2.6 TB/s (12-13 us); the last select ends 5-7 us after it, of
//    which about 1.5 us a level is the wait for a load from L2.
// Integer arithmetic only; the counters' atomics are integer sums and a
// ticket, so every run gives the same result.

#include <cuda_runtime.h>
#include <stdint.h>

// Bytes of shared memory a block may give to a segment's indices (one block
// an SM: its 1024 threads take the register file); a capacity past it keeps
// them in the scratch. A build may set it (0: always the scratch).
#ifndef PS_COMPACT_IDX_SMEM_MAX
#define PS_COMPACT_IDX_SMEM_MAX (200 * 1024)
#endif

namespace {

constexpr int B = 128;               // entries a block (a row)
constexpr int MAX_OCT = 16;
constexpr int MAX_LEVELS = 4;        // levels of the recursion
constexpr int CHUNK = 32;            // blocks a warp in the count
constexpr int LOADS = CHUNK * B / 512;   // 16-byte loads a lane a chunk
constexpr int NT = 1024;             // threads a block
constexpr int WARPS = NT / 32;
constexpr int CPW = 2;               // chunks a warp counts
constexpr int RPT = 4;               // rows a thread per select step
constexpr int LIST = NT * RPT;       // rows a select step
constexpr int TOP_K = 127;           // K of every level above the first
constexpr int CTR = 4;               // counter words a segment
constexpr unsigned FULL = 0xffffffffu;

// Division by d >= 1 of 0 <= n < 2^31 as a multiply: with 2^(s-1) < d <= 2^s
// and m = ceil(2^(31+s) / d) < 2^32, floor(n / d) = floor(n m / 2^(31+s))
// exactly (the error n (m - 2^(31+s)/d) / 2^(31+s) is below 2^-s <= 1/d).
struct Divisor {
    unsigned d, m;
    int sh;                          // s - 1; -1 for d = 1
};

Divisor divisor_of(unsigned d) {
    Divisor v = {d, 0u, -1};
    if (d > 1) {
        int s = 0;
        while ((1ull << s) < d) ++s;
        v.m = (unsigned)(((1ull << (31 + s)) + d - 1) / d);
        v.sh = s - 1;
    }
    return v;
}

struct Octave {
    const uint8_t* mask;             // u8[F, N], 0 or 1
    long long N;                     // entries a frame
    long long base;                  // scratch words of frame 0
    long long stride;                // scratch words a frame
    int HW, W;                       // plane size and width (x, y, z rows)
    Divisor div_hw, div_w;           // the same as divisions
    int cap, K, row_off, levels;
    int nb1;                         // ceil(N / B)
    int off_idx;                     // level indices within a frame (words)
    int off_bits[MAX_LEVELS];        // level l's bit words within a frame
    int blocks;                      // launch blocks a frame
    int block_end;                   // launch blocks of octaves 0..o, all frames
    int idx_smem;                    // whether its indices fit shared memory
    int pad_guess;                   // the padding entry, unless a level's
                                     // last row has entries
};

struct Table {
    Octave o[MAX_OCT];
    int n;                           // octaves
    int rows;                        // output rows a frame
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Sixteen mask bytes at entry pos .. pos+15 of a segment (0 past its end),
// as four words.
__device__ __forceinline__ uint4 load16(const uint8_t* m, long long N,
                                        long long pos, bool fast) {
    if (fast) return *reinterpret_cast<const uint4*>(m + pos);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 16; ++i)
        if (pos + i < N) w[i >> 2] |= (uint32_t)m[pos + i] << (8 * (i & 3));
    uint4 v;
    v.x = w[0];
    v.y = w[1];
    v.z = w[2];
    v.w = w[3];
    return v;
}

// Bit i of the result: byte i of x is not 0.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
    x |= x >> 4;
    x |= x >> 2;
    x |= x >> 1;                     // bit 0 of each byte: any bit of it
    return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Sum of one int a thread across the block (every thread gets it).
__device__ int block_sum(int v) {
    __shared__ int part[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    if (lane == 0) part[warp] = v;
    __syncthreads();
    int t = part[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(FULL, t, d);
    __syncthreads();                                  // part is reused
    return t;
}

// Exclusive scan of one int a thread across the block; `total` gets the sum.
__device__ int block_scan(int v, int& total) {
    __shared__ int warp_sum[WARPS];
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
    total = warp_sum[WARPS - 1];
    const int excl = x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
    __syncthreads();                                  // warp_sum is reused
    return excl;
}

// Exclusive scans of RPT ints a thread across the block, value i of thread
// t standing at position i NT + t; `total` gets the sum of all of them.
__device__ void block_scan_rows(const int (&v)[RPT], int (&ex)[RPT],
                                int& total) {
    __shared__ int warp_sum[RPT][WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) x[i] = v[i];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int y = __shfl_up_sync(FULL, x[i], d);
            if (lane >= d) x[i] += y;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) warp_sum[i][warp] = x[i];
    }
    __syncthreads();
    if (warp == 0) {
        int w[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) w[i] = warp_sum[i][lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int y = __shfl_up_sync(FULL, w[i], d);
                if (lane >= d) w[i] += y;
            }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) warp_sum[i][lane] = w[i];
    }
    __syncthreads();
    int base = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        ex[i] = base + x[i] - v[i] + (warp > 0 ? warp_sum[i][warp - 1] : 0);
        base += warp_sum[i][WARPS - 1];
    }
    total = base;
    __syncthreads();                                  // warp_sum is reused
}

// The four words of 128-bit group g of a level's bits (0 past its words),
// in one 16-byte load from L2: other blocks of the launch wrote them (a
// level's words start on a 16-byte boundary and fill whole groups).
__device__ __forceinline__ void group(const uint32_t* bits, int n_words, int g,
                                      uint32_t (&rb)[4]) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(bits) + g);
    rb[0] = 4 * g < n_words ? v.x : 0u;
    rb[1] = 4 * g + 1 < n_words ? v.y : 0u;
    rb[2] = 4 * g + 2 < n_words ? v.z : 0u;
    rb[3] = 4 * g + 3 < n_words ? v.w : 0u;
}

// floor(n / v.d), and n - v.d floor(n / v.d) in `rem`.
__device__ __forceinline__ int div_rem(int n, const Divisor& v, int& rem) {
    const int q = v.sh < 0 ? n : (int)(__umulhi((unsigned)n, v.m) >> v.sh);
    rem = n - q * (int)v.d;
    return q;
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

// A warp counts chunk c of a frame's mask `m`: the level-1 bits of its 32
// blocks and their level-2 word. Adds the lane's share of the set entries
// to `set` and of the non-empty blocks to `ne` (the warp's sums over its
// lanes are the chunk's).
__device__ __forceinline__ void count_chunk(const Octave& q, const uint8_t* m,
                                            uint32_t* fr, int c, int lane,
                                            int& set, int& ne) {
    uint32_t* bits1 = fr + q.off_bits[0];
    const long long pos0 = (long long)c * CHUNK * B + 16 * lane;
    const bool fast = ((uintptr_t)m & 15u) == 0u
                      && (long long)(c + 1) * CHUNK * B <= q.N;
    uint4 v[LOADS];
#pragma unroll
    for (int k = 0; k < LOADS; ++k) v[k] = load16(m, q.N, pos0 + 512 * k, fast);
    uint32_t nonempty = 0u;
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
        // lane l holds entries 16 (l % 8) .. +15 of block 4k + l / 8
        const uint32_t m16 = nibble(v[k].x) | nibble(v[k].y) << 4
                             | nibble(v[k].z) << 8 | nibble(v[k].w) << 12;
        const uint32_t hi = __shfl_xor_sync(FULL, m16, 1);
        int cnt = __popc(m16);
        cnt += __shfl_xor_sync(FULL, cnt, 1);
        cnt += __shfl_xor_sync(FULL, cnt, 2);
        cnt += __shfl_xor_sync(FULL, cnt, 4);
        const int blk = c * CHUNK + 4 * k + (lane >> 3);
        if (blk < q.nb1 && !(lane & 1))
            bits1[4 * blk + ((lane & 7) >> 1)] = m16 | hi << 16;
        const unsigned b = __ballot_sync(FULL, cnt > 0);
        nonempty |= ((b & 1u) | ((b >> 7) & 2u) | ((b >> 14) & 4u)
                     | ((b >> 21) & 8u)) << (4 * k);
        if (!(lane & 7)) set += cnt;
    }
    if (lane == 0) {
        fr[q.off_bits[1] + c] = nonempty;
        ne += __popc(nonempty);
    }
}

// Output rows [s0, s1) from row out0 on, row s = val(s) as (x, y, z), by the
// block's threads: four rows a 16-byte store where x0, y0 and z0 share their
// alignment.
template <class Val>
__device__ void store_rows(int* x0, int* y0, int* z0, long long out0, int s0,
                           int s1, Val val) {
    const int tid = threadIdx.x;
    const uintptr_t ax = (uintptr_t)(x0 + out0 + s0);
    const bool vec = (ax & 3u) == 0u
                     && ((ax ^ (uintptr_t)(y0 + out0 + s0)) & 15u) == 0u
                     && ((ax ^ (uintptr_t)(z0 + out0 + s0)) & 15u) == 0u;
    const int head = s0 + (vec ? imin(imax(s1 - s0, 0),
                                      (int)(((16u - (ax & 15u)) & 15u) / 4u))
                               : imax(s1 - s0, 0));
    const int quads = imax(s1 - head, 0) / 4;
    auto one = [&](int s) {
        int x, y, z;
        val(s, x, y, z);
        x0[out0 + s] = x;
        y0[out0 + s] = y;
        z0[out0 + s] = z;
    };
    for (int s = s0 + tid; s < head; s += NT) one(s);
    for (int g = tid; g < quads; g += NT) {
        const int s = head + 4 * g;
        int4 vx, vy, vz;
        val(s, vx.x, vy.x, vz.x);
        val(s + 1, vx.y, vy.y, vz.y);
        val(s + 2, vx.z, vy.z, vz.z);
        val(s + 3, vx.w, vy.w, vz.w);
        *reinterpret_cast<int4*>(x0 + out0 + s) = vx;
        *reinterpret_cast<int4*>(y0 + out0 + s) = vy;
        *reinterpret_cast<int4*>(z0 + out0 + s) = vz;
    }
    for (int s = head + 4 * quads + tid; s < s1; s += NT) one(s);
}

// Entry e of a segment's mask as (x, y, layer + 1).
__device__ __forceinline__ void xyz_of(const Octave& q, int e, int& x, int& y,
                                       int& z) {
    int rem;
    z = div_rem(e, q.div_hw, rem) + 1;
    y = div_rem(rem, q.div_w, x);
}

// The select of one segment, by one block, once every block of the segment
// has counted: the levels from the top down, level l's rows being level
// l+1's entries. Level l writes its entries as flat indices into idx[l % 2]
// (shared memory where the capacity fits, else the segment's scratch), and
// level l-1 reads them from there. Whatever the count blocks wrote is read
// from L2 with __ldcg; the counters are asked for first and used last, so
// that their round trip overlaps the first level's.
__device__ void select_segment(const Table& t, const Octave& q, uint32_t* fr,
                               const int* ctr, int* smem_idx, int f, int seg,
                               int* __restrict__ x0, int* __restrict__ y0,
                               int* __restrict__ z0,
                               long long* __restrict__ n_found,
                               long long* __restrict__ n_dropped) {
    __shared__ int s_count[MAX_LEVELS + 1];
    __shared__ int s_last[2];                // the last row: id, count
    __shared__ uint32_t s_last_bits[4];
    __shared__ int s_list[LIST];             // ids of the live rows of a step
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int D = q.levels, cap = q.cap;
    // set entries of the mask and non-empty blocks, in flight meanwhile
    int set_all = 0, ne_all = 0;
    if (tid == 0) {
        set_all = __ldcg(ctr + 1);
        ne_all = __ldcg(ctr + 2);
    }

    // bit counts and words of each level: level 0 is the mask, level l+1
    // the "non-empty" bits of level l's 128-bit groups
    long long n[MAX_LEVELS];
    int n_words[MAX_LEVELS];
    n[0] = q.N;
    for (int l = 1; l < MAX_LEVELS; ++l) n[l] = (n[l - 1] + B - 1) / B;
    n_words[0] = 4 * q.nb1;
    n_words[1] = (q.nb1 + CHUNK - 1) / CHUNK;
    for (int l = 2; l < MAX_LEVELS; ++l) n_words[l] = (int)((n[l] + 31) / 32);
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
        const int tot = block_sum(ne);
        if (tid == 0) s_count[l] = tot;
        __syncthreads();                          // dst complete for level l
    }

    int* idx[2];
    idx[0] = smem_idx != nullptr ? smem_idx
                                 : reinterpret_cast<int*>(fr + q.off_idx);
    idx[1] = idx[0] + cap;
    const uint32_t* bits1 = fr + q.off_bits[1];
    const long long out0 = (long long)f * t.rows + q.row_off;
    int carry = 0;
    for (int l = D - 1; l >= 0; --l) {
        const bool top = l == D - 1;
        const int K = l == 0 ? q.K : TOP_K;
        const int n_rows = top ? (int)((n[l] + B - 1) / B) : cap;
        const uint32_t* bits = fr + q.off_bits[l];
        int* out = idx[l & 1];
        const int* in = idx[(l + 1) & 1];
        // the last row, if no step meets it: empty
        const int last_row = top ? n_rows - 1 : in[cap - 1];
        if (tid == 0) {
            s_last[0] = last_row;
            s_last[1] = 0;
            for (int w = 0; w < 4; ++w) s_last_bits[w] = 0u;
        }
        carry = 0;
        // One step: rows k < m, row k taken by thread k % NT (so that a run
        // of dense rows spreads over the lanes of a warp, whose entries are
        // written one after another), whose ids id_at(k) give their groups;
        // one scan places their kept entries after `carry`; last(k) names
        // the segment's last row.
        auto step = [&](int m, auto id_at, auto last) {
            int id[RPT], cnt[RPT], ex[RPT];
            uint32_t rb[RPT][4];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int k = i * NT + tid;
                id[i] = k < m ? id_at(k) : 0;
                rb[i][0] = rb[i][1] = rb[i][2] = rb[i][3] = 0u;
                if (k < m) group(bits, n_words[l], id[i], rb[i]);
                cnt[i] = imin(popc4(rb[i]), K);
            }
            int tot;
            block_scan_rows(cnt, ex, tot);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int k = i * NT + tid;
                if (k >= m) break;
                // this row's kept entries, in lane order, at off, off+1, ...
                const int off = ex[i] + carry;
                int s = off;
                for (int w = 0; w < 4 && s < off + cnt[i] && s < cap; ++w) {
                    uint32_t x = rb[i][w];
                    while (x != 0u && s < off + cnt[i] && s < cap) {
                        out[s++] = id[i] * B + 32 * w + __ffs((int)x) - 1;
                        x &= x - 1u;
                    }
                }
                if (last(k, id[i])) {
                    s_last[0] = id[i];
                    s_last[1] = cnt[i];
                    for (int w = 0; w < 4; ++w) s_last_bits[w] = rb[i][w];
                }
            }
            carry += tot;
        };
        if (top && D == 1) {
            // the mask's blocks are the rows: only the non-empty ones (the
            // set bits of level 1) take a step, LIST at a time, in order
            for (int w0 = 0; w0 < n_words[1]; w0 += NT) {
                const int w = w0 + tid;
                const uint32_t word = w < n_words[1] ? __ldcg(bits1 + w) : 0u;
                int n_live;
                const int pos = block_scan(__popc(word), n_live);
                for (int j0 = 0; j0 < n_live; j0 += LIST) {
                    uint32_t x = word;
                    for (int p = pos; x != 0u && p < j0 + LIST; ++p) {
                        if (p >= j0) s_list[p - j0] = 32 * w + __ffs((int)x) - 1;
                        x &= x - 1u;
                    }
                    __syncthreads();
                    step(imin(LIST, n_live - j0),
                         [&](int k) { return s_list[k]; },
                         [&](int, int r) { return r == n_rows - 1; });
                    __syncthreads();              // s_list is reused
                }
            }
        } else {
            // rows 0 .. n_rows-1 of the top level, or the first
            // min(cap, non-empty groups) rows named by the level above (the
            // rest are empty)
            const int live = top ? n_rows : imin(cap, s_count[l + 1]);
            for (int t0 = 0; t0 < live; t0 += LIST) {
                if (top)
                    step(imin(LIST, live - t0),
                         [&](int k) { return t0 + k; },
                         [&](int k, int) { return t0 + k == n_rows - 1; });
                else
                    step(imin(LIST, live - t0),
                         [&](int k) { return in[t0 + k]; },
                         [&](int k, int) { return t0 + k == cap - 1; });
            }
        }
        if (tid == 0) s_count[1] = ne_all;        // level 0's live rows
        __syncthreads();
        // padding entries past the kept ones: the last row's entry of rank
        // clamp(s - off, 0, K-1) (off: the row's first entry), or its lane 0
        // past the row's count. The last row's entries are the last kept
        // ones, so for every s >= carry that is lane 0, or the entry of rank
        // K-1 where the row keeps K.
        const int last_id = s_last[0], last_cnt = s_last[1];
        uint32_t lb[4];
        for (int w = 0; w < 4; ++w) lb[w] = s_last_bits[w];
        const int e_pad =
            last_id * B + (last_cnt == K ? lane_of_rank(lb, K - 1) : 0);
        if (l > 0) {
            // only the rows level l-1 reads: its live ones and its last
            const int lim = imin(cap, s_count[l]);
            for (int s = carry + tid; s < lim; s += NT) out[s] = e_pad;
            if (tid == 0 && carry < cap) out[cap - 1] = e_pad;
            __syncthreads();                      // out complete
            continue;
        }
        // level 0: the kept entries from their flat indices, and the
        // padding unless the count blocks wrote it already (q.pad_guess)
        store_rows(x0, y0, z0, out0, 0, e_pad == q.pad_guess ? imin(carry, cap)
                                                              : cap,
                   [&](int s, int& x, int& y, int& z) {
                       xyz_of(q, s < carry ? out[s] : e_pad, x, y, z);
                   });
    }
    if (tid == 0) {
        n_found[seg] = imin(carry, cap);
        n_dropped[seg] = (long long)set_all - carry;
    }
}

__global__ void __launch_bounds__(NT)
compact_kernel(Table t, uint32_t* scratch, int* __restrict__ x0,
               int* __restrict__ y0, int* __restrict__ z0,
               long long* __restrict__ n_found,
               long long* __restrict__ n_dropped) {
    extern __shared__ int smem_idx[];
    __shared__ int s_last_block;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int id = blockIdx.x;
    int o = 0;
    while (id >= t.o[o].block_end) ++o;
    if (o > 0) id -= t.o[o - 1].block_end;
    const Octave& q = t.o[o];
    const int f = id / q.blocks;
    const int seg = f * t.n + o;
    int* ctr = reinterpret_cast<int*>(scratch) + CTR * seg;
    uint32_t* fr = scratch + q.base + (size_t)f * (size_t)q.stride;
    const int n_chunks = (q.nb1 + CHUNK - 1) / CHUNK;
    int set = 0, ne = 0;
    for (int j = 0; j < CPW; ++j) {
        const int c = ((id - f * q.blocks) * CPW + j) * WARPS + warp;
        if (c < n_chunks)                               // uniform in the warp
            count_chunk(q, q.mask + (size_t)f * (size_t)q.N, fr, c, lane,
                        set, ne);
    }
    // the segment's output rows as its padding entry where every level's
    // last row is empty (lane 0 of the last row of every level: so in all
    // but masks whose last rows hold candidates), a share a block; the
    // select writes the kept rows over them, or every row where the
    // padding is another
    {
        const int j = id - f * q.blocks;
        const long long out0 = (long long)f * t.rows + q.row_off;
        int cx, cy, cz;
        xyz_of(q, q.pad_guess, cx, cy, cz);
        store_rows(x0, y0, z0, out0, (int)((long long)q.cap * j / q.blocks),
                   (int)((long long)q.cap * (j + 1) / q.blocks),
                   [&](int, int& x, int& y, int& z) {
                       x = cx;
                       y = cy;
                       z = cz;
                   });
    }
    const int set_tot = block_sum(set);
    const int ne_tot = block_sum(ne);
    // publish the block's bits (the barrier orders every thread's stores
    // before thread 0's fence, which orders them before its ticket), then
    // take a ticket; the last block's fence orders the other blocks' bits
    // before its reads, which go to L2
    if (tid == 0) {
        atomicAdd(ctr + 1, set_tot);
        atomicAdd(ctr + 2, ne_tot);
        __threadfence();
        s_last_block = atomicAdd(ctr, 1) == q.blocks - 1;
        if (s_last_block) __threadfence();
    }
    __syncthreads();
    if (!s_last_block) return;                       // uniform in the block
    select_segment(t, q, fr, ctr, q.idx_smem ? smem_idx : nullptr, f, seg,
                   x0, y0, z0, n_found, n_dropped);
}

}  // namespace

// Compaction of n_oct octaves' masks of F frames. `table` is a host array
// i64[n_oct, 15]: mask address (u8[F, N]), N, H*W, W, cap, K, first output
// row of the octave in a frame, levels, scratch base (words), scratch words a
// frame, then the offsets within a frame of the level indices (2 cap ints)
// and of the bits of levels 0..3. The scratch's first 4 F n_oct words are
// the segments' counters (zeroed here); `rows` is the output rows a frame;
// x0, y0, z0 are i32[F * rows], n_found and n_dropped i64[F, n_oct].
extern "C" int ps_compact_octaves(const long long* table, int n_oct, int F,
                                  int rows, void* scratch, int* x0, int* y0,
                                  int* z0, long long* n_found,
                                  long long* n_dropped, void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT || F < 1) return (int)cudaErrorInvalidValue;
    Table t = {};
    t.n = n_oct;
    t.rows = rows;
    long long blocks = 0;
    size_t smem = 0;
    for (int o = 0; o < n_oct; ++o) {
        const long long* r = table + 15 * o;
        Octave& q = t.o[o];
        q.mask = (const uint8_t*)(uintptr_t)r[0];
        q.N = r[1];
        q.HW = (int)r[2];
        q.W = (int)r[3];
        q.div_hw = divisor_of((unsigned)q.HW);
        q.div_w = divisor_of((unsigned)q.W);
        q.cap = (int)r[4];
        q.K = (int)r[5];
        q.row_off = (int)r[6];
        q.levels = (int)r[7];
        q.base = r[8];
        q.stride = r[9];
        q.off_idx = (int)r[10];
        for (int l = 0; l < MAX_LEVELS; ++l) q.off_bits[l] = (int)r[11 + l];
        if (q.N < 1 || q.N > 0x7fffffffLL || q.cap < 1 || q.K < 1 || q.K > TOP_K
            || q.levels < 1 || q.levels > MAX_LEVELS || q.W < 1 || q.HW < 1
            || q.base < (long long)CTR * F * n_oct)
            return (int)cudaErrorInvalidValue;
        q.nb1 = (int)((q.N + B - 1) / B);
        // lane 0 of the last row of the top level, B^(levels-1) down
        long long n_top = q.N;
        for (int l = 1; l < q.levels; ++l) n_top = (n_top + B - 1) / B;
        long long guess = (n_top + B - 1) / B - 1;
        for (int l = 0; l < q.levels; ++l) guess *= B;
        q.pad_guess = (int)guess;
        q.blocks = (int)(((q.nb1 + CHUNK - 1) / CHUNK + WARPS * CPW - 1)
                         / (WARPS * CPW));
        blocks += (long long)F * q.blocks;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
        q.block_end = (int)blocks;
        // indices: level 0's, and for more levels those of the level above
        const size_t need = sizeof(int) * (size_t)q.cap
                            * (q.levels == 1 ? 1 : 2);
        q.idx_smem = need <= (size_t)PS_COMPACT_IDX_SMEM_MAX;
        if (q.idx_smem && need > smem) smem = need;
    }
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(compact_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    err = cudaMemsetAsync(scratch, 0, sizeof(int) * CTR * F * n_oct, s);
    if (err != cudaSuccess) return (int)err;
    compact_kernel<<<(int)blocks, NT, smem, s>>>(t, (uint32_t*)scratch, x0,
                                                 y0, z0, n_found, n_dropped);
    return (int)cudaGetLastError();
}
