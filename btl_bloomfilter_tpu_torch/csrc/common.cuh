// Shared definitions of the port's CUDA kernels (plain C entry points,
// loaded with ctypes by kernels/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Bit position of an invalid window: every slot of its positions holds it,
// and inserts and queries skip it. Filter sizes stay below 2**32 so it is
// never a real position.
#define BTL_SENTINEL 0xFFFFFFFFu

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
