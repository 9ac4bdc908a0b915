// K1: DoG extremum candidate mask.
//
// Replaces: popsift_tpu/ops/pallas/extrema_mask.py:candidate_mask_canvas_pallas
// (and its dense and frame-batched siblings, which compute the same mask).
//
// Semantics: out[z-1, y, x] = |c| >= thr1 and (c > all 26 neighbours or
// c < all 26 neighbours), c = dog[z, y, x], for z = 1 .. D-2 of a dense
// f32[D, H, W] stack; the outermost pixels of a plane are false (with edge
// replication they can never be strict extrema, as in the edge-padded XLA
// twin, popsift_tpu/ops/extrema.py:115-125). The DoG holds no NaN, so
// "c > all 26" is "c > max of the 26" exactly (+0 and -0 compare alike) and
// the mask equals the plain version bit for bit.
//
// What bounds it on the H100: memory. At octave 0 of a 1080p frame the
// DoG stack is 5 x 2160 x 3840 f32 (166 MB) and the mask 3 x 8.3 M bytes;
// the nine octaves of a frame together 254 MB.
//
// What the design does about it:
//  * A strip march in registers. A warp owns a strip of 128 columns and a
//    band of rows and walks down it; each lane owns four consecutive
//    columns (one aligned 16-byte load per layer and row, one 4-byte store
//    per output layer and row) and keeps three rows of every layer in
//    registers, with the loads of a fourth in flight a step ahead of its
//    use. No shared memory, no barrier: warps are independent.
//  * Separable max / min. When row y+1 arrives, each lane takes the
//    vertical 3-max and 3-min of its four columns in every layer and gets
//    those of the two columns beside them from the neighbouring lanes (four
//    shuffles a layer). A layer's 3 x 3 max is then two more operations a
//    pixel, the centre layer's 8-neighbour ring three; the 26-neighbour
//    max is max(3 x 3 below, 3 x 3 above, ring). About 85 operations for
//    the three outputs of a pixel column, nothing read twice by a lane.
//  * The contrast gate first. Where no pixel of a warp's row passes
//    |c| >= thr1 in any layer (one vote), the row's masks are zero and all
//    of the above is skipped. It costs about a tenth where every row has a
//    passing pixel and saves a third of the kernel's time on a frame whose
//    finest octaves are smooth.
//  * Strips overlap by one lane on each side: lanes 0 and 31 only feed
//    their neighbours, lanes 1..30 write 120 columns, and strips advance
//    by 120 columns (480 bytes: loads stay 16-byte aligned and cover whole
//    32-byte sectors). So no lane is special and no column is loaded apart.
//    Bands are short (BAND_ROWS = 8): their halo rows come from L2, which
//    the neighbouring bands' warps fill at the same time, and four times
//    the warps of a 32-row band balance the SMs better (measured: bands of
//    8, 16, 32, 64, 128 rows take 1.00, 1.04, 1.07, 1.12, 1.74 x the time
//    where the gate skips nothing).
//  * One launch for all octaves of a frame or a batch: a by-value table of
//    (DoG pointer, mask pointer, D, H, W, ...) per octave; a warp's work
//    item is (octave, frame, layer group, band, strip), octave 0 first.
//    F frames' stacks lie back to back, f32[F*D, H, W] -> u8[F, D-2, H, W];
//    a warp never reads across its frame's D layers. Stacks of more than
//    five layers are walked in groups of three output layers.
//  * Planes whose width is no multiple of four, or whose rows are not
//    16-byte aligned, take scalar loads and stores with clamped columns;
//    so do the lanes that straddle a plane's edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                  // warps a block, one work item each
constexpr int NT = WARPS * 32;
constexpr int PX = 4;                     // columns a lane
constexpr int STRIP = (32 - 2) * PX;      // columns a warp writes
constexpr int ZG = 3;                     // output layers a march
constexpr int BAND_ROWS = 8;              // rows a work item
constexpr int MAX_OCT = 16;
constexpr unsigned FULL = 0xffffffffu;

struct MaskTable {
    const float* dog[MAX_OCT];    // f32[F*D, H, W]
    uint8_t* out[MAX_OCT];        // u8[F, D-2, H, W]
    int D[MAX_OCT];
    int H[MAX_OCT];
    int W[MAX_OCT];
    int n_strips[MAX_OCT];
    int n_bands[MAX_OCT];
    int vec[MAX_OCT];             // 16-byte loads and 4-byte stores allowed
    int item_end[MAX_OCT];        // items [item_end[o-1], item_end[o]) are octave o's
    int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// columns c .. c+3 of a row, clamped to the plane where they leave it
__device__ __forceinline__ void load4(const float* __restrict__ row, int c,
                                      int W, bool in4, float (&v)[PX]) {
    if (in4) {
        const float4 t = *reinterpret_cast<const float4*>(row + c);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
        for (int i = 0; i < PX; ++i) v[i] = row[clampi(c + i, 0, W - 1)];
    }
}

// NZ output layers (input layers 0 .. NZ+1 of `dog`, outputs 0 .. NZ-1 of
// `out`) of columns [c, c+4) and rows [y0, y1) of one H x W plane stack.
template <int NZ>
__device__ __forceinline__ void march(const float* __restrict__ dog,
                                      uint8_t* __restrict__ out, size_t plane,
                                      int H, int W, int c, int y0, int y1,
                                      bool vec, bool writer, float thr1) {
    constexpr int NL = NZ + 2;
    const bool in4 = vec && c >= 0 && c + PX <= W;
    float a[NL][PX], b[NL][PX], n[NL][PX];   // rows y-1, y, y+1
    float p[NL][PX];                         // row y+2, in flight
    {
        const size_t ra = (size_t)max(y0 - 1, 0) * W;
        const size_t rb = (size_t)y0 * W;
        const size_t rn = (size_t)min(y0 + 1, H - 1) * W;
#pragma unroll
        for (int l = 0; l < NL; ++l) {
            load4(dog + l * plane + ra, c, W, in4, a[l]);
            load4(dog + l * plane + rb, c, W, in4, b[l]);
            load4(dog + l * plane + rn, c, W, in4, n[l]);
        }
    }
    for (int y = y0; y < y1; ++y) {
        if (y + 1 < y1) {       // the next step's row, asked for a step ahead
            const size_t rp = (size_t)min(y + 2, H - 1) * W;
#pragma unroll
            for (int l = 0; l < NL; ++l)
                load4(dog + l * plane + rp, c, W, in4, p[l]);
        }
        // the contrast gate first: where no pixel of the warp's row passes
        // it in any layer, the row's masks are zero without the 26 neighbours
        bool pass = false;
#pragma unroll
        for (int z = 1; z <= NZ; ++z) {
#pragma unroll
            for (int i = 0; i < PX; ++i)
                pass = pass || fabsf(b[z][i]) >= thr1;
        }
        uint32_t bits[NZ];
#pragma unroll
        for (int z = 0; z < NZ; ++z) bits[z] = 0u;
        if (__any_sync(FULL, pass)) {
            // vertical 3-max / 3-min of this lane's columns, and those of
            // the columns left and right of them from the neighbouring lanes
            float vx[NL][PX + 2], vn[NL][PX + 2];
#pragma unroll
            for (int l = 0; l < NL; ++l) {
#pragma unroll
                for (int i = 0; i < PX; ++i) {
                    vx[l][i + 1] = fmaxf(fmaxf(a[l][i], b[l][i]), n[l][i]);
                    vn[l][i + 1] = fminf(fminf(a[l][i], b[l][i]), n[l][i]);
                }
                vx[l][0] = __shfl_up_sync(FULL, vx[l][PX], 1);
                vn[l][0] = __shfl_up_sync(FULL, vn[l][PX], 1);
                vx[l][PX + 1] = __shfl_down_sync(FULL, vx[l][1], 1);
                vn[l][PX + 1] = __shfl_down_sync(FULL, vn[l][1], 1);
            }
            // per layer the 3 x 3 max / min (m9) and, for the layers that
            // hold a centre, the 8-neighbour ring
            float m9x[NL][PX], m9n[NL][PX], rgx[NL][PX], rgn[NL][PX];
#pragma unroll
            for (int l = 0; l < NL; ++l) {
#pragma unroll
                for (int i = 0; i < PX; ++i) {
                    const float sx = fmaxf(vx[l][i], vx[l][i + 2]);
                    const float sn = fminf(vn[l][i], vn[l][i + 2]);
                    if (l >= 1 && l <= NZ) {
                        rgx[l][i] = fmaxf(sx, fmaxf(a[l][i], n[l][i]));
                        rgn[l][i] = fminf(sn, fminf(a[l][i], n[l][i]));
                        m9x[l][i] = fmaxf(rgx[l][i], b[l][i]);
                        m9n[l][i] = fminf(rgn[l][i], b[l][i]);
                    } else {
                        m9x[l][i] = fmaxf(sx, vx[l][i + 1]);
                        m9n[l][i] = fminf(sn, vn[l][i + 1]);
                    }
                }
            }
            const bool yin = y >= 1 && y <= H - 2;
#pragma unroll
            for (int z = 1; z <= NZ; ++z) {
#pragma unroll
                for (int i = 0; i < PX; ++i) {
                    const float cv = b[z][i];
                    const float hi = fmaxf(
                        fmaxf(m9x[z - 1][i], m9x[z + 1][i]), rgx[z][i]);
                    const float lo = fminf(
                        fminf(m9n[z - 1][i], m9n[z + 1][i]), rgn[z][i]);
                    const int x = c + i;
                    const bool m = yin && x >= 1 && x <= W - 2
                        && fabsf(cv) >= thr1 && (cv > hi || cv < lo);
                    bits[z - 1] |= (m ? 1u : 0u) << (8 * i);
                }
            }
        }
        if (writer) {
#pragma unroll
            for (int z = 0; z < NZ; ++z) {
                uint8_t* dst = out + (size_t)z * plane + (size_t)y * W;
                if (in4) {
                    *reinterpret_cast<uint32_t*>(dst + c) = bits[z];
                } else {
#pragma unroll
                    for (int i = 0; i < PX; ++i)
                        if (c + i >= 0 && c + i < W)
                            dst[c + i] = (uint8_t)((bits[z] >> (8 * i)) & 1u);
                }
            }
        }
#pragma unroll
        for (int l = 0; l < NL; ++l) {
#pragma unroll
            for (int i = 0; i < PX; ++i) {
                a[l][i] = b[l][i];
                b[l][i] = n[l][i];
                n[l][i] = p[l][i];
            }
        }
    }
}

// Three blocks of four warps an SM: up to 170 registers a thread, which the
// rows in flight need (held to 128 the kernel spills and runs 1.6 x slower).
__global__ void __launch_bounds__(NT, 3)
extrema_mask_kernel(MaskTable tab, float thr1) {
    const int lane = threadIdx.x & 31;
    int id = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (id >= tab.item_end[tab.n - 1]) return;     // uniform across the warp
    int o = 0;
    while (id >= tab.item_end[o]) ++o;
    if (o > 0) id -= tab.item_end[o - 1];
    const int D = tab.D[o], H = tab.H[o], W = tab.W[o];
    const int strip = id % tab.n_strips[o];
    id /= tab.n_strips[o];
    const int band = id % tab.n_bands[o];
    id /= tab.n_bands[o];
    const int n_groups = (D - 2 + ZG - 1) / ZG;
    const int group = id % n_groups;
    const int f = id / n_groups;
    const size_t plane = (size_t)H * (size_t)W;
    const int z0 = group * ZG;                     // first input layer
    const float* dog = tab.dog[o] + ((size_t)f * D + z0) * plane;
    uint8_t* out = tab.out[o] + ((size_t)f * (D - 2) + z0) * plane;
    const int c = strip * STRIP + (lane - 1) * PX;
    const int y0 = band * BAND_ROWS;
    const int y1 = min(H, y0 + BAND_ROWS);
    const bool vec = tab.vec[o] != 0;
    const bool writer = lane >= 1 && lane <= 30;
    switch (min(ZG, D - 2 - z0)) {
    case 3: march<3>(dog, out, plane, H, W, c, y0, y1, vec, writer, thr1); break;
    case 2: march<2>(dog, out, plane, H, W, c, y0, y1, vec, writer, thr1); break;
    default: march<1>(dog, out, plane, H, W, c, y0, y1, vec, writer, thr1);
    }
}

}  // namespace

// One launch over n_oct octaves of F frames. `table` is a host array
// i64[n_oct, 5]: DoG address (f32[F*D, H, W]), mask address
// (u8[F, D-2, H, W]), D, H, W.
extern "C" int ps_extrema_mask_octaves(const long long* table, int n_oct,
                                       int F, float thr1, void* stream) {
    if (n_oct < 1 || n_oct > MAX_OCT || F < 1) return (int)cudaErrorInvalidValue;
    MaskTable tab = {};
    tab.n = n_oct;
    long long items = 0;
    for (int o = 0; o < n_oct; ++o) {
        const long long* t = table + 5 * o;
        const long long D = t[2], H = t[3], W = t[4];
        if (D < 3 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
        tab.dog[o] = (const float*)(uintptr_t)t[0];
        tab.out[o] = (uint8_t*)(uintptr_t)t[1];
        tab.D[o] = (int)D;
        tab.H[o] = (int)H;
        tab.W[o] = (int)W;
        tab.n_strips[o] = (int)((W + STRIP - 1) / STRIP);
        tab.n_bands[o] = (int)((H + BAND_ROWS - 1) / BAND_ROWS);
        tab.vec[o] = W % PX == 0 && t[0] % 16 == 0 && t[1] % 4 == 0;
        items += (long long)F * ((D - 2 + ZG - 1) / ZG) * tab.n_bands[o]
               * tab.n_strips[o];
        if (items > 0x7fffffffLL - WARPS) return (int)cudaErrorInvalidValue;
        tab.item_end[o] = (int)items;
    }
    const int grid = (int)((items + WARPS - 1) / WARPS);
    extrema_mask_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(tab, thr1);
    return (int)cudaGetLastError();
}
