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
// whole DRAM sector. Measured, the loads take as long issued one after
// another as issued together: random-access DRAM throughput bounds it, not
// latency. Design: one thread per window (no grid-stride loop); the
// position loads (plane-major [h, n]) and all stores are coalesced across
// the warp. A window's word loads are issued together, as independent loads
// held in registers, before any of them is compared, in groups of up to
// G_MAX slots (all of them for h <= G_MAX). When only the hit is wanted,
// slot 0 is loaded alone first: a miss usually stops after that one load,
// a hit costs two round trips; a window stops after the first group whose
// minimum falls below the threshold. An invalid window loads nothing unless
// the values are wanted.
//
// Semantics: a sentinel slot reads 0; a window whose slot 0 is the sentinel
// is invalid (min 0, hit false); a word index past the array is clamped to
// the last word, as an XLA gather clamps. Positions are uint32 with the
// sentinel 0xFFFFFFFF below 2**32 counters; a filter of exactly 2**32
// counters (0xFFFFFFFF a real counter) takes wide positions, int64 with -1
// the sentinel, through an instantiation of its own.

#include "common.cuh"

#define G_MAX 8

// P: uint32_t, or long long for wide positions.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
gather_counters_kernel(const P* __restrict__ pos, long long n, int h,
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
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const bool valid = !btl_is_sentinel(pos[i]);
    uint32_t mn = 0xFFFFFFFFu;
    if (valid || vals) {
        for (int j0 = 0; j0 < h;) {
            int g = hit_only && j0 == 0 ? 1 : G_MAX;
            if (g > h - j0) g = h - j0;
            P p[G_MAX];
            uint32_t v[G_MAX];
#pragma unroll
            for (int j = 0; j < G_MAX; ++j)
                if (j < g) p[j] = pos[(long long)(j0 + j) * n + i];
            // every load of the group issued before any is used
#pragma unroll
            for (int j = 0; j < G_MAX; ++j) {
                if (j < g) {
                    long long w = (long long)(p[j] >> shift);
                    if (w >= nwords) w = nwords - 1;
                    v[j] = btl_is_sentinel(p[j]) ? 0u : __ldg(&words[w]);
                }
            }
#pragma unroll
            for (int j = 0; j < G_MAX; ++j) {
                if (j < g) {
                    if (!btl_is_sentinel(p[j]))
                        v[j] = (v[j] >> (((uint32_t)p[j] & sub_mask) * bits))
                               & lane_mask;
                    if (vals) vals[(long long)(j0 + j) * n + i] = v[j];
                    mn = v[j] < mn ? v[j] : mn;
                }
            }
            j0 += g;
            if (hit_only && mn < threshold) break;
        }
    }
    if (mins) mins[i] = valid ? mn : 0u;
    if (hit) hit[i] = valid && mn >= threshold;
}

template <typename P>
static int launch(const void* pos, long long n, int h, const void* words,
                  long long nwords, int shift, unsigned long long threshold,
                  void* vals, void* mins, void* hit, int device,
                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((n + BTL_BLOCK - 1) / BTL_BLOCK);
    gather_counters_kernel<P><<<blocks, BTL_BLOCK, 0,
                                (cudaStream_t)stream>>>(
        (const P*)pos, n, h, (const unsigned int*)words, nwords, shift,
        threshold, (uint32_t*)vals, (uint32_t*)mins, (bool*)hit);
    return (int)cudaGetLastError();
}

// pos uint32 [h, n] plane-major; words uint32 [nwords]; outputs (each may
// be null): vals uint32 [h, n], mins uint32 [n], hit bool [n].
extern "C" int btl_gather_counters(const void* pos, long long n, int h,
                                   const void* words, long long nwords,
                                   int shift, unsigned long long threshold,
                                   void* vals, void* mins, void* hit,
                                   int device, void* stream) {
    return launch<uint32_t>(pos, n, h, words, nwords, shift, threshold, vals,
                            mins, hit, device, stream);
}

// The same for wide positions: pos int64 [h, n], -1 the sentinel.
extern "C" int btl_gather_counters_wide(const void* pos, long long n, int h,
                                        const void* words, long long nwords,
                                        int shift,
                                        unsigned long long threshold,
                                        void* vals, void* mins, void* hit,
                                        int device, void* stream) {
    return launch<long long>(pos, n, h, words, nwords, shift, threshold,
                             vals, mins, hit, device, stream);
}
