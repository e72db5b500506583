// Bloom insert of SORTED bit positions: words[p >> 5] |= 1 << (p & 31),
// with one atomicOr per run of equal words in a warp instead of one per
// position.
//
// Replaces two TPU kernels that compute this one function:
//   btl_bloomfilter_tpu/kernels/scatter_or.py:scatter_or_sorted (_kernel,
//     pallas_call at :158): a 16384-word window read-modify-written per
//     1024-position chunk, the window's delta built as an MXU one-hot
//     product;
//   btl_bloomfilter_tpu/kernels/scatter_ring.py:scatter_or_sorted
//     (_kernel, pallas_call at :234): the same histogram accumulated in a
//     VMEM ring of slots and flushed into a zeros delta array.
// Both need sorted, deduplicated positions so a chunk fits a window, and
// count the positions that overflow it for the caller to re-apply. Hopper
// has atomics in L2 and needs no window: every position is applied and the
// overflow is always 0. The delta form is this kernel run on a zeros
// array (kernels/scatter_ring.py), the in-place form on the filter
// (kernels/scatter_or.py).
//
// What bounds it on the H100: the 4-byte read-modify-writes into a filter
// larger than the 50 MB L2 (2**30 bits = 128 MiB), each touching a 32-byte
// sector. Design: the sort is exploited, not required. One thread per
// position; warp shuffles mark runs of equal word index (a run head is
// lane 0 or a word different from the lane before), a segmented OR scan
// folds each run's masks, and the run's last lane issues the one atomicOr.
// Sentinels (0xFFFFFFFF) and positions past nwords form runs of their own
// that issue nothing. Duplicates replaced by sentinels in place break the
// monotone order; a sentinel inside a run splits it into two atomics on
// one word, which is still exact: OR commutes, so the result never depends
// on the run detection.

#include "common.cuh"

#define BTL_FULL_MASK 0xFFFFFFFFu

__global__ void __launch_bounds__(BTL_BLOCK)
scatter_or_sorted_kernel(const uint32_t* __restrict__ pos, long long n,
                         unsigned int* __restrict__ words,
                         long long nwords) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // base is the same for every thread of the block, so all 32 lanes of
    // a warp run the same iterations and every shuffle sees a full warp
    for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
         base += stride) {
        const long long i = base + threadIdx.x;
        int w = -1;                 // word index; -1 applies nothing
        unsigned int m = 0;
        if (i < n) {
            const uint32_t p = pos[i];
            if (p != BTL_SENTINEL && (long long)(p >> 5) < nwords) {
                w = (int)(p >> 5);
                m = 1u << (p & 31);
            }
        }
        const int wprev = __shfl_up_sync(BTL_FULL_MASK, w, 1);
        const int wnext = __shfl_down_sync(BTL_FULL_MASK, w, 1);
        // segmented inclusive OR scan: (f, v) of the lanes before this one
        // fold in until a run head is reached
        int f = (lane == 0 || wprev != w);
        unsigned int v = m;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned int vu = __shfl_up_sync(BTL_FULL_MASK, v, d);
            const int fu = __shfl_up_sync(BTL_FULL_MASK, f, d);
            if (lane >= d && !f) {
                v |= vu;
                f = fu;
            }
        }
        const bool tail = lane == 31 || wnext != w;
        if (tail && w >= 0) atomicOr(&words[w], v);
    }
}

// pos uint32 [n] (sorted for one atomic per run; any order is exact);
// words uint32 [nwords], updated in place.
extern "C" int btl_scatter_or_sorted(const void* pos, long long n,
                                     void* words, long long nwords,
                                     int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    scatter_or_sorted_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)pos, n, (unsigned int*)words, nwords);
    return (int)cudaGetLastError();
}
