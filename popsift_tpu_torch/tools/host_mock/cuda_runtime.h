// Host stand-in for <cuda_runtime.h>: lets g++ compile a kernel source of
// popsift_tpu_torch/csrc and run it on the CPU, one std::thread per CUDA
// thread (tools/host_mock.py builds with it). Blocks of a grid run one after
// another, each with all its threads alive: __syncthreads and __syncwarp are
// std::barriers, __shfl_xor_sync exchanges through a per-warp buffer between
// two warp barriers (__shfl_up_sync, __shfl_down_sync and __any_sync
// likewise, a lane without a source keeping its own value), __shared__
// variables are statics (one block at a time) and dynamic shared memory is a
// buffer of the launch. It provides what desc.cu, blur_dog.cu,
// extrema_mask.cu and orient.cu use; a source that needs more (atomics, other
// shuffles, textures) has to add it here. It checks indexing and arithmetic,
// not races between blocks, and it is no measure of speed.
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
inline float mock_xchg[64][32];
inline unsigned char* mock_dyn_smem;
inline int mock_tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline void __syncthreads() { mock_block_bar->arrive_and_wait(); }
inline void __syncwarp() { mock_warp_bar[mock_tid() >> 5]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int d) {
    int t = mock_tid(), w = t >> 5, l = t & 31;
    mock_xchg[w][l] = v;
    mock_warp_bar[w]->arrive_and_wait();
    float r = mock_xchg[w][l ^ d];
    mock_warp_bar[w]->arrive_and_wait();
    return r;
}
inline float mock_shfl(float v, int delta) {
    int t = mock_tid(), w = t >> 5, l = t & 31, src = l + delta;
    int n = std::min(32, (int)(blockDim.x * blockDim.y * blockDim.z) - 32 * w);
    mock_xchg[w][l] = v;
    mock_warp_bar[w]->arrive_and_wait();
    float r = (src >= 0 && src < n) ? mock_xchg[w][src] : v;
    mock_warp_bar[w]->arrive_and_wait();
    return r;
}
inline float __shfl_up_sync(unsigned, float v, int d) { return mock_shfl(v, -d); }
inline float __shfl_down_sync(unsigned, float v, int d) { return mock_shfl(v, d); }
inline int __any_sync(unsigned, int pred) {
    int t = mock_tid(), w = t >> 5, l = t & 31;
    int n = std::min(32, (int)(blockDim.x * blockDim.y * blockDim.z) - 32 * w);
    mock_xchg[w][l] = pred ? 1.f : 0.f;
    mock_warp_bar[w]->arrive_and_wait();
    int any = 0;
    for (int i = 0; i < n; ++i) any |= mock_xchg[w][i] != 0.f;
    mock_warp_bar[w]->arrive_and_wait();
    return any;
}
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
