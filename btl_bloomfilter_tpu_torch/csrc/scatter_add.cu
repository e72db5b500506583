// Counting-filter update: counters[p] = min(counters[p] + inc, counter_max)
// for every (position, increment) pair, in place on packed counters (lane
// p & (per-1) of 32-bit word p >> shift, per = 1 << shift). Positions come
// in any order, with duplicates; the sentinel 0xFFFFFFFF, a zero increment
// and a word index past the array are no-ops. With no increment array
// every pair adds 1 (incrementAll).
//
// Replaces: btl_bloomfilter_tpu/kernels/scatter_add.py:_kernel (built by
// _make_weighted_kernel, behind scatter_add_weighted_sorted and its unit
// wrapper scatter_add_sorted), together with the (position, delta) sort and
// the window-overflow re-apply around it in models/counting.py
// (_insert_positions_kernel, insert_all). The TPU needs sorted positions to
// stream windows through VMEM and builds per-lane sums with bf16 one-hot
// matmuls, which bound increments below 2**24. Hopper updates a word with
// atomicCAS in L2: any order, duplicates, full uint32 increments.
//
// What bounds it on the H100: one random 4-byte compare-and-swap per pair
// into a word array far larger than the L2, each moving a 32-byte sector;
// a CAS retries only when another thread changed the same word in between.
// Design: one thread per pair in a grid-stride loop with coalesced pair
// loads. The new lane value is computed in 64 bits and clamped at
// counter_max before it is put back in its lane, so a sum never carries
// into the neighbouring lane; a lane already at counter_max is left alone
// without a CAS. Saturating adds of non-negative increments compose in any
// order: min(min(c + a, M) + b, M) = min(c + a + b, M).

#include "common.cuh"

__global__ void __launch_bounds__(BTL_BLOCK)
scatter_add_kernel(const uint32_t* __restrict__ pos,
                   const uint32_t* __restrict__ inc, long long n,
                   unsigned int* __restrict__ words, long long nwords,
                   int shift, uint32_t counter_max) {
    const unsigned bits = 32u >> shift;
    const unsigned lane_mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    const uint32_t sub_mask = (1u << shift) - 1u;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const uint32_t p = pos[i];
        if (p == BTL_SENTINEL) continue;
        const uint32_t c = inc ? inc[i] : 1u;
        if (c == 0) continue;
        const long long w = p >> shift;
        if (w >= nwords) continue;
        const unsigned sh = (p & sub_mask) * bits;
        unsigned int* addr = &words[w];
        unsigned int old = *((volatile unsigned int*)addr);
        while (true) {
            const uint32_t lane = (old >> sh) & lane_mask;
            if (lane >= counter_max) break;
            unsigned long long nl = (unsigned long long)lane + c;
            if (nl > counter_max) nl = counter_max;
            const unsigned int upd =
                (old & ~(lane_mask << sh)) | ((uint32_t)nl << sh);
            const unsigned int seen = atomicCAS(addr, old, upd);
            if (seen == old) break;
            old = seen;
        }
    }
}

// pos uint32 [n] (any order, duplicates allowed); inc uint32 [n] or null
// (every increment 1); words uint32 [nwords], updated in place.
extern "C" int btl_scatter_add(const void* pos, const void* inc, long long n,
                               void* words, long long nwords, int shift,
                               unsigned int counter_max, int device,
                               void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const uint32_t*)pos, (const uint32_t*)inc, n, (unsigned int*)words,
        nwords, shift, counter_max);
    return (int)cudaGetLastError();
}
