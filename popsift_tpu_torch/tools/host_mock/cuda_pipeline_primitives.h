// Host stand-in for <cuda_pipeline_primitives.h> (tools/host_mock.py): an
// asynchronous copy into shared memory is a copy made at once, so commit and
// wait have nothing to do. Threads of a block still run concurrently, so a
// copy into a buffer that another thread is reading without a barrier between
// them can show here as on the card.
#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
    std::memcpy(dst, src, size - zfill);
    std::memset((char*)dst + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
