// Bloom query: for every window, load the h words words[p_j >> 5], test
// every bit, and write hit & valid.
//
// Replaces: btl_bloomfilter_tpu/kernels/gather_words.py:_kernel (built by
// _make_kernel(5), behind gather_words_sorted), together with the sort, the
// packed un-sort, the AND over h and the window-overflow fallback around it
// in models/bloom.py contains_sentinel_positions. The TPU gathers through
// sorted windows of the filter; on Hopper a direct load needs no sort, so
// the gather and the AND over the h hashes fuse into one pass.
//
// What bounds it on the H100: random 4-byte loads from the filter (128 MiB
// at 2**30 bits, beyond the 50 MB L2), h per window, each moving a 32-byte
// sector. Design: one thread per window in a grid-stride loop; the h
// position loads are coalesced across the warp (plane-major [h, B, W]); a
// window stops loading at its first clear bit, so misses cost fewer loads.
// Measured on the H100 at bench.py's batch (PERF.md), this chain of loads
// already runs faster than torch's words[idx] over the same word indices,
// and a redesign with four windows a thread, slot 0 first and the other
// planes' loads issued together, ran no faster (one window a thread) or
// slower (four): random-sector DRAM throughput bounds it, not the chain.
// Semantics follow the reference: a window whose slot-0 position is the
// sentinel is False; a sentinel in another slot reads bit 0; a word index
// past the filter is clamped to the last word, as an XLA gather clamps.
// Wide positions (int64, sentinel -1; filters from 2**32 bits) take an
// instantiation of their own.

#include "common.cuh"

// P: uint32_t, or long long for wide positions.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
gather_words_kernel(const P* __restrict__ pos, long long n, int h,
                    const unsigned int* __restrict__ words, long long nwords,
                    bool* __restrict__ hit) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        bool all = !btl_is_sentinel(pos[i]);
        for (int j = 0; j < h && all; ++j) {
            P p = pos[(long long)j * n + i];
            if (btl_is_sentinel(p)) p = 0;
            long long w = p >> 5;
            if (w >= nwords) w = nwords - 1;
            all = (__ldg(&words[w]) >> (p & 31)) & 1u;
        }
        hit[i] = all;
    }
}

// pos uint32 [h, n] plane-major; words uint32 [nwords]; hit bool [n].
extern "C" int btl_gather_words(const void* pos, long long n, int h,
                                const void* words, long long nwords,
                                void* hit, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    gather_words_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)pos, n, h, (const unsigned int*)words, nwords,
        (bool*)hit);
    return (int)cudaGetLastError();
}

// The same for wide positions: pos int64 [h, n], -1 the sentinel.
extern "C" int btl_gather_words_wide(const void* pos, long long n, int h,
                                     const void* words, long long nwords,
                                     void* hit, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    gather_words_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                          (cudaStream_t)stream>>>(
        (const long long*)pos, n, h, (const unsigned int*)words, nwords,
        (bool*)hit);
    return (int)cudaGetLastError();
}
