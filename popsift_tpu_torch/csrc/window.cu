// K6: per-candidate window copy from a layered volume.
//
// Replaces: popsift_tpu/ops/pallas/window.py:extract_windows_pallas (the
// Pallas call at :95) and its frame-batched form
// extract_windows_pallas_batched (:214), which feed the unfused refinement
// (popsift_tpu/ops/extrema.py:refine_candidates) with each candidate's
// [D, 11, 11] DoG neighbourhood.
//
// What bounds it on the H100: bytes, and few of them. A window is
// D * rows * cols floats (605 for the refinement's 5 x 11 x 11), read from
// rows of the DoG stack that neighbouring candidates share (L2 serves the
// overlap) and written once. A 1080p frame has a few thousand live
// candidates, so the copy moves a few MB; the rest of the capacity-padded
// output is zeros.
//
// What the design does about it: one block per candidate row, the threads
// striding over the window's elements with the column fastest, so a warp
// reads runs of `cols` consecutive floats and writes consecutive floats. The
// live count is read from device memory (a frame's n_found), so the host
// never reads it back to size the launch: blocks at or past the count write
// their row's zeros and leave. Nothing of the TPU kernel's aligned [24, 256]
// DMA window, roll or 8/128 alignment carries over.
//
// Semantics: window cell (d, i, j) of candidate k holds
// vol[zbase + d, clamp(cy[k] - radius + i, 0, H-1),
//     clamp(cx[k] - radius + j, 0, W-1)],
// which is the JAX twin's slice at clip(c - radius) of the volume edge-padded
// by `radius` (popsift_tpu/ops/extrema.py:377-388). Batched entry: the F
// frames' D-layer stacks lie back to back, f32[F*D, H, W]; row k belongs to
// frame f = k / cap, reads layers [f*D, f*D + D) only and is live below
// n_found[f]. A copy: equal to the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Row k of `cap` rows per frame; n_found holds one count per frame.
__global__ void __launch_bounds__(NT)
extract_windows_kernel(const float* __restrict__ vol,
                       const int* __restrict__ cy, const int* __restrict__ cx,
                       const int* __restrict__ n_found, int cap, int D, int H,
                       int W, int radius, int rows, int cols,
                       float* __restrict__ out) {
    const int k = blockIdx.x;
    const int f = k / cap;
    const int n = D * rows * cols;
    float* o = out + (size_t)k * n;
    if (k - f * cap >= n_found[f]) {   // uniform across the block
        for (int e = threadIdx.x; e < n; e += NT) o[e] = 0.f;
        return;
    }
    const size_t plane = (size_t)H * (size_t)W;
    const float* v = vol + (size_t)f * (size_t)D * plane;
    const int y0 = cy[k] - radius;
    const int x0 = cx[k] - radius;
    for (int e = threadIdx.x; e < n; e += NT) {
        const int j = e % cols;
        const int i = (e / cols) % rows;
        const int d = e / (cols * rows);
        const int y = clampi(y0 + i, 0, H - 1);
        const int x = clampi(x0 + j, 0, W - 1);
        o[e] = __ldg(v + (size_t)d * plane + (size_t)y * W + x);
    }
}

}  // namespace

// vol f32[F*D, H, W]; cy, cx i32[F*cap]; n_found i32[F] on the device;
// out f32[F*cap, D, rows, cols]. F = 1 is the single-frame entry.
extern "C" int ps_extract_windows_batched(const float* vol, const int* cy,
                                          const int* cx, const int* n_found,
                                          int F, int cap, int D, int H, int W,
                                          int radius, int rows, int cols,
                                          float* out, void* stream) {
    if (F < 1 || cap < 1 || D < 1 || H < 1 || W < 1 || rows < 1 || cols < 1)
        return (int)cudaErrorInvalidValue;
    extract_windows_kernel<<<F * cap, NT, 0, (cudaStream_t)stream>>>(
        vol, cy, cx, n_found, cap, D, H, W, radius, rows, cols, out);
    return (int)cudaGetLastError();
}

extern "C" int ps_extract_windows(const float* vol, const int* cy,
                                  const int* cx, const int* n_valid, int K,
                                  int D, int H, int W, int radius, int rows,
                                  int cols, float* out, void* stream) {
    return ps_extract_windows_batched(vol, cy, cx, n_valid, 1, K, D, H, W,
                                      radius, rows, cols, out, stream);
}
