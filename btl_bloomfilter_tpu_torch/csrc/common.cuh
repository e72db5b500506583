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

// The multi-hash derivation (nthash.hpp:537-542): hash i of a k-mer's h
// from its canonical hash, km = k * BTL_MULTI_SEED; hash 0 is the
// canonical hash itself. ntHash and the spaced-seed hash both derive with
// it.
#define BTL_MULTI_SEED 0x90B45D39FB6DA1FAULL
#define BTL_MULTI_SHIFT 27

__device__ __forceinline__ uint64_t btl_derive_hash(uint64_t canon, int i,
                                                    uint64_t km) {
    if (i == 0) return canon;
    const uint64_t v = canon * ((uint64_t)i ^ km);
    return v ^ (v >> BTL_MULTI_SHIFT);
}

// v % size: a mask when magic == 0 (size a power of two), else Barrett:
// q = mulhi(v, magic) >> shift is floor(v/size) or one less, for any size
// below 2**63 (magic = floor(2**(63+p) / size) < 2**64, p its bit length;
// kernels/nthash_scan.py barrett).
__device__ __forceinline__ uint64_t btl_mod_size64(uint64_t v, uint64_t size,
                                                   uint64_t magic,
                                                   int shift) {
    if (magic == 0) return v & (size - 1);
    uint64_t q = __umul64hi(v, magic) >> shift;
    uint64_t r = v - q * size;
    if (r >= size) r -= size;
    return r;
}

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
