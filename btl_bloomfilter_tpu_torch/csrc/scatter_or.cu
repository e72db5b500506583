// Bloom insert: words[p >> 5] |= 1 << (p & 31) for every bit position p,
// in place, skipping the sentinel: uint32 positions with 0xFFFFFFFF below
// 2**32 bits, and wide ones, int64 with -1, from 2**32 to 2**36 bits (each
// entry point has a _wide twin; the narrow instantiations are unchanged).
//
// Replaces: btl_bloomfilter_tpu/kernels/scatter_ring.py:_kernel_rmw (behind
// scatter_or_sorted_inplace), together with the sort, the dedupe and the
// window-overflow fallback around it in models/bloom.py
// insert_sentinel_positions. The TPU needs sorted, deduplicated positions
// to stream filter windows through VMEM; Hopper has atomicOr in L2, which
// takes positions in any order and with duplicates. OR commutes, so the
// words are bit-identical to the sorted form. There is no overflow path.
// A position whose word is outside the filter is dropped, as the
// reference's scatter (mode="drop") drops it.
//
// What bounds it on the H100: random 4-byte read-modify-writes into the
// filter (2**30 bits = 128 MiB, larger than the 50 MB L2), one per position,
// each moving a 32-byte sector. Two routes (kernels/scatter_or.py picks one
// by the filter's words and the number of positions):
//   direct: one thread per position in a grid-stride loop with coalesced
//     position loads; the atomics resolve in L2. No set-up, so it wins
//     where the filter sits in L2 or the positions are few.
//   tiled: the tile partition (tile_partition.cu) groups the positions by
//     64 KiB tile of the filter; then one block a non-empty tile builds
//     the tile's new bits in shared memory with shared atomicOr and ORs
//     them into the filter in address order, one atomicOr per word that
//     gains a bit: the positions' duplicates and order are gone, and a
//     warp's 32 consecutive words share 4 sectors. It moves only the
//     sectors that gain a bit. The other design measured (the direct body
//     over the grouped positions, blocks dispatched in order so the lines
//     in flight stay in L2) was slower at every shape the rule sends here
//     (PERF.md).

#include "tile_partition.cuh"

// P: uint32_t, or long long for wide positions.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
scatter_or_kernel(const P* __restrict__ pos, long long n,
                  unsigned int* __restrict__ words, long long nwords) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const P p = pos[i];
        if (btl_is_sentinel(p)) continue;
        const long long w = p >> 5;
        if (w >= nwords) continue;
        atomicOr(&words[w], 1u << (p & 31));
    }
}

// pos uint32 [n] (any order, duplicates allowed); words uint32 [nwords],
// updated in place.
extern "C" int btl_scatter_or(const void* pos, long long n, void* words,
                              long long nwords, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    scatter_or_kernel<<<btl_blocks(n), BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pos, n, (unsigned int*)words, nwords);
    return (int)cudaGetLastError();
}

// The same for wide positions: pos int64 [n], -1 the sentinel.
extern "C" int btl_scatter_or_wide(const void* pos, long long n, void* words,
                                   long long nwords, int device,
                                   void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    scatter_or_kernel<<<btl_blocks(n), BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const long long*)pos, n, (unsigned int*)words, nwords);
    return (int)cudaGetLastError();
}

// The tiled route's apply: block t builds tile t's delta in shared memory,
// then ORs each nonzero word of it into the filter. kWide: grouped holds
// wide positions' low 32 bits (tile_partition.cuh), whose bits 5 and up
// hold the word inside the tile; no slot of a run is the sentinel there,
// so the slots past a run are masked off by index instead.
template <bool kWide>
__global__ void __launch_bounds__(BTL_TILE_THREADS)
scatter_or_tile_kernel(const uint32_t* __restrict__ grouped,
                       const uint32_t* __restrict__ offsets,
                       unsigned int* __restrict__ words, long long nwords) {
    extern __shared__ uint4 delta4[];
    uint32_t* delta = reinterpret_cast<uint32_t*>(delta4);
    const long long t = blockIdx.x;
    const uint32_t lo = offsets[t], hi = offsets[t + 1];
    if (lo == hi) return;
    const long long w0 = t << BTL_TILE_SHIFT;
    const int len = (int)(nwords - w0 < BTL_TILE_WORDS ? nwords - w0
                                                        : BTL_TILE_WORDS);
    for (int i = threadIdx.x; i < BTL_TILE_WORDS / 4; i += blockDim.x)
        delta4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (uint32_t i0 = lo + threadIdx.x; i0 < hi; i0 += 4 * blockDim.x) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t i = i0 + j * blockDim.x;
            p[j] = i < hi ? grouped[i] : BTL_SENTINEL;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (kWide) {
                if (i0 + j * blockDim.x < hi)
                    atomicOr(&delta[(p[j] >> 5) & (BTL_TILE_WORDS - 1)],
                             1u << (p[j] & 31));
            } else if (p[j] != BTL_SENTINEL) {
                atomicOr(&delta[(p[j] >> 5) - w0], 1u << (p[j] & 31));
            }
        }
    }
    __syncthreads();
    // the words that gain a bit, in address order: a warp's atomicOr
    // (no return, so the block does not wait on them) covers 32
    // consecutive words
    unsigned int* g = words + w0;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const uint32_t d = delta[i];
        if (d) atomicOr(&g[i], d);
    }
}

// The apply after a partition, on stream st.
template <bool kWide>
static cudaError_t apply_tiles(long long n, void* words, long long nwords,
                               void* scratch, int device, cudaStream_t st) {
    static unsigned long long smem_set = 0;
    cudaError_t err = btl_allow_smem(scatter_or_tile_kernel<kWide>,
                                     BTL_TILE_WORDS * sizeof(uint32_t),
                                     device, &smem_set);
    if (err != cudaSuccess) return err;
    const BtlTileScratch s = btl_tile_scratch((uint32_t*)scratch, n, nwords);
    scatter_or_tile_kernel<kWide><<<(unsigned)btl_ntiles(nwords),
                                    BTL_TILE_THREADS,
                                    BTL_TILE_WORDS * sizeof(uint32_t), st>>>(
        s.pos, s.offsets, (unsigned int*)words, nwords);
    return cudaGetLastError();
}

// The tiled route: partition, then apply, all on the given stream. pos
// uint32 [n]; words uint32 [nwords]; scratch as btl_tile_partition_run
// takes it.
extern "C" int btl_scatter_or_tiled(const void* pos, long long n,
                                    void* words, long long nwords,
                                    void* scratch, int device,
                                    void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    err = btl_tile_partition_run((const uint32_t*)pos, n, nwords, 5,
                                 (uint32_t*)scratch, st);
    if (err != cudaSuccess || n == 0) return (int)err;
    return (int)apply_tiles<false>(n, words, nwords, scratch, device, st);
}

// The same for wide positions: pos int64 [n], -1 the sentinel.
extern "C" int btl_scatter_or_tiled_wide(const void* pos, long long n,
                                         void* words, long long nwords,
                                         void* scratch, int device,
                                         void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    err = btl_tile_partition_run_wide((const long long*)pos, n, nwords, 5,
                                      (uint32_t*)scratch, st);
    if (err != cudaSuccess || n == 0) return (int)err;
    return (int)apply_tiles<true>(n, words, nwords, scratch, device, st);
}
