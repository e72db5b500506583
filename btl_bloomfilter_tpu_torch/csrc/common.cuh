// Shared definitions of the port's CUDA kernels (plain C entry points,
// loaded with ctypes by kernels/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Bit position of an invalid window: every slot of its positions holds it,
// and inserts and queries skip it. Bloom positions come in two forms. The
// narrow one, uint32 with this sentinel, serves filters below 2**32 bits,
// where it is never a real position. From 2**32 bits (at 2**32 exactly
// 0xFFFFFFFF is a real position) to 2**36, positions are wide: int64, with
// -1, any negative value, as the sentinel.
#define BTL_SENTINEL 0xFFFFFFFFu

__device__ __forceinline__ bool btl_is_sentinel(uint32_t p) {
    return p == BTL_SENTINEL;
}

__device__ __forceinline__ bool btl_is_sentinel(long long p) {
    return p < 0;
}

// Threads per block of every kernel here.
#define BTL_BLOCK 256

// Make sure the launch lands on the card the tensors live on. The wrapper
// makes that device current before the call (kernels/_build.py), so this
// only reads the current device; it sets it where a caller did not.
static inline cudaError_t btl_set_device(int device) {
    int cur;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == device) return err;
    return cudaSetDevice(device);
}

// Blocks for a grid-stride loop over n items: enough to fill the card,
// never more than the items need.
static inline unsigned btl_blocks(long long n) {
    long long b = (n + BTL_BLOCK - 1) / BTL_BLOCK;
    const long long cap = 132LL * 32;   // 32 blocks per SM on a 132-SM H100
    if (b > cap) b = cap;
    return (unsigned)(b < 1 ? 1 : b);
}
