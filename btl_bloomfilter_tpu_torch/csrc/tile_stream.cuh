// The tile load of the probe scatters that rewrite a whole array tile by
// tile (scatter_or_sorted.cu's delta form, window_scatter.cu's null
// variant): one block a 64 KiB tile starts the tile's copy into shared
// memory with cp.async, 16 bytes a copy and no registers held, so that the
// block can load what it applies (positions, chunk indices) while the tile
// is in flight, and waits for it only where it first needs it.
#pragma once

#include "tile_partition.cuh"

__device__ __forceinline__ void btl_cp_async16(uint32_t* s,
                                               const uint32_t* g) {
    const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(sa), "l"(g) : "memory");
}

__device__ __forceinline__ void btl_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void btl_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of the len words at g into s: 16 bytes a cp.async where g
// is 16-byte aligned, the words past the last whole vector (every word of
// an unaligned g) by plain loads; then commit one copy group, whatever
// len, so that every thread counts the same groups.
__device__ __forceinline__ void btl_stream_load(uint32_t* s,
                                                const uint32_t* g, int len) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        const int nv = len >> 2;
        for (int i = threadIdx.x; i < nv; i += blockDim.x)
            btl_cp_async16(s + 4 * i, g + 4 * i);
        done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += blockDim.x) s[i] = g[i];
    btl_cp_async_commit();
}

// Words of tile t of an array of nwords words.
__device__ __forceinline__ int btl_tile_len(long long t, long long nwords) {
    const long long rest = nwords - (t << BTL_TILE_SHIFT);
    return (int)(rest < BTL_TILE_WORDS ? rest : BTL_TILE_WORDS);
}
