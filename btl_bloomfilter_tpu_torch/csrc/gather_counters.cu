// Counting-filter read: for every window, load the h packed counters
// counters[p_j] (lane p_j & (per-1) of word p_j >> shift, per = 1 << shift
// counters per 32-bit word), and write any of: the per-slot values, their
// minimum over h, and the query's min >= threshold.
//
// Replaces: btl_bloomfilter_tpu/kernels/gather_words.py:_kernel in counter
// mode (built by _make_kernel(shift) with shift 0/1/2, behind
// gather_words_sorted), together with the sort, lane extract and un-sort of
// models/counting.py gather_counters_kernel and the window-overflow
// recompute of min_count. The TPU streams sorted windows of the word array
// through VMEM; on Hopper a direct load needs no sort, so the gather, the
// lane extract and the min over h fuse into one pass.
//
// What bounds it on the H100: random 4-byte loads from the word array (2**30
// u8 counters = 1 GiB, far beyond the 50 MB L2), h per window, each moving a
// 32-byte sector. Design: one thread per window in a grid-stride loop; the
// position loads (plane-major [h, n]) and all stores are coalesced across
// the warp. When only the hit is wanted, a window stops loading at its first
// counter below the threshold.
//
// Semantics: a sentinel slot reads 0; a window whose slot 0 is the sentinel
// is invalid (min 0, hit false); a word index past the array is clamped to
// the last word, as an XLA gather clamps.

#include "common.cuh"

__global__ void __launch_bounds__(BTL_BLOCK)
gather_counters_kernel(const uint32_t* __restrict__ pos, long long n, int h,
                       const unsigned int* __restrict__ words,
                       long long nwords, int shift,
                       unsigned long long threshold,
                       uint32_t* __restrict__ vals,
                       uint32_t* __restrict__ mins,
                       bool* __restrict__ hit) {
    const unsigned bits = 32u >> shift;
    const unsigned lane_mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    const uint32_t sub_mask = (1u << shift) - 1u;
    const bool hit_only = vals == nullptr && mins == nullptr;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const bool valid = pos[i] != BTL_SENTINEL;
        uint32_t mn = 0xFFFFFFFFu;
        for (int j = 0; j < h; ++j) {
            const uint32_t p = pos[(long long)j * n + i];
            uint32_t v = 0;
            if (p != BTL_SENTINEL) {
                long long w = p >> shift;
                if (w >= nwords) w = nwords - 1;
                v = (__ldg(&words[w]) >> ((p & sub_mask) * bits)) & lane_mask;
            }
            if (vals) vals[(long long)j * n + i] = v;
            mn = v < mn ? v : mn;
            if (hit_only && (!valid || mn < threshold)) break;
        }
        if (mins) mins[i] = valid ? mn : 0u;
        if (hit) hit[i] = valid && mn >= threshold;
    }
}

// pos uint32 [h, n] plane-major; words uint32 [nwords]; outputs (each may
// be null): vals uint32 [h, n], mins uint32 [n], hit bool [n].
extern "C" int btl_gather_counters(const void* pos, long long n, int h,
                                   const void* words, long long nwords,
                                   int shift, unsigned long long threshold,
                                   void* vals, void* mins, void* hit,
                                   int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    gather_counters_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)pos, n, h, (const unsigned int*)words, nwords,
        shift, threshold, (uint32_t*)vals, (uint32_t*)mins, (bool*)hit);
    return (int)cudaGetLastError();
}
