// Blocked Bloom filter insert and query: every k-mer's h bits lie in one
// 512-bit block (16 words, one 64-byte line) of the filter, rows [nblocks,
// 16]. From the k-mer's canonical hash c:
//   block = c mod nblocks,  bit j = derive(c, j) & 511 for j = 1..h
// (derive the ntHash multi-hash, btl_derive_hash; slot 0 is c itself and
// picks the block).
//
// Replaces: btl_bloomfilter_tpu/models/blocked.py insert and contains.
// No Pallas kernel there: the JAX package turns the blocked insert into
// global bit positions and runs them through the classic path's sort,
// dedupe and sorted-delta scatter, and the query into an XLA row gather
// with 16 lane selects. The JAX positions are uint32 with 0xFFFFFFFF as the
// sentinel, so at exactly 2**32 bits it drops bit 2**32 - 1; here there are
// no positions, so that bit is set like any other (a block index and a
// word of its row, in 64 bits).
//
// What bounds it on the H100: one random 64-byte line a k-mer, far beyond
// the 50 MB L2 at 2**30 bits (128 MiB, 2**21 lines): two 32-byte sectors of
// the line at most, where the classic filter's h bits touch h lines.
// Design (a first one, one thread a k-mer in a grid-stride loop): the
// canonical hashes and the valid flags load coalesced; the block is a
// Barrett modulo (kernels/nthash_scan.py barrett); the h bits become 16
// word masks in registers (a compare-select a word, no indexed register
// array, so nothing spills to local memory). The insert ORs each nonzero
// mask into its word with one atomicOr whose result is unused (a
// fire-and-forget reduction in L2): at most min(h, 16) atomics a k-mer,
// all into one line. The query loads the line as four 16-byte read-only
// loads and tests every mask; an invalid k-mer loads nothing.

#include "common.cuh"

#define BLOCKED_WORDS 16

// The 16 word masks of a k-mer's h in-block bits.
__device__ __forceinline__ void blocked_masks(uint64_t canon, int h,
                                              uint64_t km,
                                              uint32_t m[BLOCKED_WORDS]) {
#pragma unroll
    for (int w = 0; w < BLOCKED_WORDS; ++w) m[w] = 0u;
    for (int j = 1; j <= h; ++j) {
        const uint32_t bit = (uint32_t)btl_derive_hash(canon, j, km) & 511u;
        const uint32_t word = bit >> 5, b = 1u << (bit & 31u);
#pragma unroll
        for (int w = 0; w < BLOCKED_WORDS; ++w)
            m[w] |= word == (uint32_t)w ? b : 0u;
    }
}

__global__ void __launch_bounds__(BTL_BLOCK)
blocked_insert_kernel(const uint64_t* __restrict__ canon,
                      const bool* __restrict__ valid, long long n,
                      unsigned int* __restrict__ rows, uint64_t nblocks,
                      uint64_t magic, int shift, int h, uint64_t km) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (valid != nullptr && !valid[i]) continue;
        const uint64_t c = canon[i];
        uint32_t m[BLOCKED_WORDS];
        blocked_masks(c, h, km, m);
        unsigned int* row =
            rows + btl_mod_size64(c, nblocks, magic, shift) * BLOCKED_WORDS;
#pragma unroll
        for (int w = 0; w < BLOCKED_WORDS; ++w)
            if (m[w]) atomicOr(&row[w], m[w]);
    }
}

__global__ void __launch_bounds__(BTL_BLOCK)
blocked_contains_kernel(const uint64_t* __restrict__ canon,
                        const bool* __restrict__ valid, long long n,
                        const unsigned int* __restrict__ rows,
                        uint64_t nblocks, uint64_t magic, int shift, int h,
                        uint64_t km, bool* __restrict__ hit) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (valid != nullptr && !valid[i]) {
            hit[i] = false;
            continue;
        }
        const uint64_t c = canon[i];
        const uint4* line = reinterpret_cast<const uint4*>(
            rows + btl_mod_size64(c, nblocks, magic, shift) * BLOCKED_WORDS);
        const uint4 q0 = __ldg(line), q1 = __ldg(line + 1);
        const uint4 q2 = __ldg(line + 2), q3 = __ldg(line + 3);
        const uint32_t r[BLOCKED_WORDS] = {q0.x, q0.y, q0.z, q0.w,
                                           q1.x, q1.y, q1.z, q1.w,
                                           q2.x, q2.y, q2.z, q2.w,
                                           q3.x, q3.y, q3.z, q3.w};
        uint32_t m[BLOCKED_WORDS];
        blocked_masks(c, h, km, m);
        bool all = true;
#pragma unroll
        for (int w = 0; w < BLOCKED_WORDS; ++w) all &= (r[w] & m[w]) == m[w];
        hit[i] = all;
    }
}

// canon uint64 [n] canonical hashes; valid bool [n] or null (every k-mer
// valid); rows uint32 [nblocks, 16], 16-byte aligned, updated in place;
// (magic, shift) the Barrett constants of nblocks; km = k * multiSeed.
extern "C" int btl_blocked_insert(const void* canon, const void* valid,
                                  long long n, void* rows, long long nblocks,
                                  unsigned long long magic, int shift, int h,
                                  unsigned long long km, int device,
                                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks < 1 || h < 1) return (int)cudaErrorInvalidValue;
    blocked_insert_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                            (cudaStream_t)stream>>>(
        (const uint64_t*)canon, (const bool*)valid, n, (unsigned int*)rows,
        (uint64_t)nblocks, magic, shift, h, km);
    return (int)cudaGetLastError();
}

// The query: arguments as btl_blocked_insert's, hit bool [n] out (false
// where valid is false).
extern "C" int btl_blocked_contains(const void* canon, const void* valid,
                                    long long n, const void* rows,
                                    long long nblocks,
                                    unsigned long long magic, int shift,
                                    int h, unsigned long long km, void* hit,
                                    int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks < 1 || h < 1 || (reinterpret_cast<uintptr_t>(rows) & 15))
        return (int)cudaErrorInvalidValue;
    blocked_contains_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                              (cudaStream_t)stream>>>(
        (const uint64_t*)canon, (const bool*)valid, n,
        (const unsigned int*)rows, (uint64_t)nblocks, magic, shift, h, km,
        (bool*)hit);
    return (int)cudaGetLastError();
}
