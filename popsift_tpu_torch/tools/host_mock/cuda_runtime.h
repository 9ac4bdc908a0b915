// Host stand-in for <cuda_runtime.h>: lets g++ compile a kernel source of
// popsift_tpu_torch/csrc and run it on the CPU, one std::thread per CUDA
// thread (tools/host_mock.py builds with it). Blocks of a grid run one after
// another, each with all its threads alive: __syncthreads and __syncwarp are
// std::barriers, __shfl_xor_sync exchanges any type of up to 8 bytes through a
// per-warp buffer between two warp barriers (__shfl_up_sync,
// __shfl_down_sync, __ballot_sync and __any_sync likewise, a lane without a
// source keeping its own value), __shared__
// variables are statics (one block at a time) and dynamic shared memory is a
// buffer of the launch. It provides what desc.cu, blur_dog.cu,
// extrema_mask.cu, orient.cu, refine.cu, compact.cu and blur_chain.cu use
// (__ldg, __ldcg, __popc, __ffs, __umulhi, integer atomicAdd,
// __threadfence and cudaMemsetAsync too); a source that needs more (other
// shuffles, textures) has to add it here. It checks indexing and
// arithmetic, not races between blocks, and it is no measure of speed.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* mock_block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> mock_warp_bar;
inline uint64_t mock_xchg[64][32];
inline unsigned char* mock_dyn_smem;
inline int mock_tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline void __syncthreads() { mock_block_bar->arrive_and_wait(); }
inline void __syncwarp() { mock_warp_bar[mock_tid() >> 5]->arrive_and_wait(); }
template <class T> inline uint64_t mock_bits(T v) { uint64_t r = 0; std::memcpy(&r, &v, sizeof(T)); return r; }
template <class T> inline T mock_from(uint64_t r) { T v; std::memcpy(&v, &r, sizeof(T)); return v; }
inline int mock_warp_size(int w) { return std::min(32, (int)(blockDim.x * blockDim.y * blockDim.z) - 32 * w); }
// lane l reads lane src(l) of its warp; a lane without a source keeps its value
template <class T, class Src> inline T mock_exchange(T v, Src src) {
    int t = mock_tid(), w = t >> 5, l = t & 31, n = mock_warp_size(w);
    mock_xchg[w][l] = mock_bits(v);
    mock_warp_bar[w]->arrive_and_wait();
    int s = src(l);
    T r = (s >= 0 && s < n) ? mock_from<T>(mock_xchg[w][s]) : v;
    mock_warp_bar[w]->arrive_and_wait();
    return r;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int d) { return mock_exchange(v, [d](int l) { return l ^ d; }); }
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) { return mock_exchange(v, [d](int l) { return l - d; }); }
template <class T> inline T __shfl_down_sync(unsigned, T v, int d) { return mock_exchange(v, [d](int l) { return l + d; }); }
inline unsigned __ballot_sync(unsigned, int pred) {
    int t = mock_tid(), w = t >> 5, l = t & 31, n = mock_warp_size(w);
    mock_xchg[w][l] = pred ? 1u : 0u;
    mock_warp_bar[w]->arrive_and_wait();
    unsigned bits = 0u;
    for (int i = 0; i < n; ++i) bits |= (mock_xchg[w][i] ? 1u : 0u) << i;
    mock_warp_bar[w]->arrive_and_wait();
    return bits;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0u; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline T atomicAdd(T* p, T v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __float2int_rn(float v) { return (int)std::nearbyintf(v); }
using std::max; using std::min;
inline void mock_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> body) {
    int nt = block.x * block.y * block.z;
    std::barrier<> bar(nt);
    mock_block_bar = &bar;
    mock_warp_bar.clear();
    for (int w = 0; w < (nt + 31) / 32; ++w)
        mock_warp_bar.emplace_back(new std::barrier<>(std::min(32, nt - 32 * w)));
    std::vector<unsigned char> dyn(smem + 64);
    mock_dyn_smem = (unsigned char*)(((uintptr_t)dyn.data() + 63) / 64 * 64);
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
        th.emplace_back([=, &bar] {
            blockDim = block; gridDim = grid;
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            for (unsigned bz = 0; bz < grid.z; ++bz)
                for (unsigned by = 0; by < grid.y; ++by)
                    for (unsigned bx = 0; bx < grid.x; ++bx) {
                        blockIdx = dim3(bx, by, bz);
                        body();
                        bar.arrive_and_wait();
                    }
        });
    for (auto& x : th) x.join();
}
