// Counting-filter conservative step, fused: for every frame of h packed
// counters (lane p & (per-1) of 32-bit word p >> shift, per = 1 << shift)
// repeated c times, gather the counters, take their minimum mn, and raise
// every counter to target = mn + min(c, counter_max - mn). It is
// incrementMin for c = 1 and the closed form of c repeats of one frame,
// the freeze at counter_max included.
//
// Replaces: btl_bloomfilter_tpu/models/counting.py:_closed_form_add and its
// TPU route _insert_positions_kernel (the counter-mode gather_words_sorted
// of kernels/gather_words.py:297, the (position, delta) sort and the
// weighted scatter_add_weighted_sorted of kernels/scatter_add.py:194), and
// the per-frame _make_word_step (the c = 1 case). On the TPU the closed
// form is a windowed gather, a sort and a windowed scatter-add, because the
// TPU streams sorted windows through VMEM; on Hopper one thread per frame
// reads and writes its counters directly, so the gather, the min, the
// target and the write fuse into one pass with no [h, n] temporaries.
//
// Exactness without a compare-and-swap. The caller guarantees that
//   * the frames of one step are position-disjoint (no counter belongs to
//     two frames), which the decomposition's closed-form rows and every
//     replay round are by construction;
// and the kernel guarantees that
//   * an in-frame duplicate slot writes once (only its first slot writes);
//   * each write adds delta = target - cur to its lane, with cur < target
//     <= counter_max.
// So each lane receives at most one add, and that add leaves the lane at
// target <= counter_max: it never carries into the neighbouring lane, and
// the lane a thread reads is written by nobody else during the step (other
// frames' adds to the same word touch other lanes). A plain atomicAdd whose
// result is unused is then exact; it compiles to a fire-and-forget RED.
//
// What bounds it on the H100: random sectors of a word array far larger
// than the 50 MB L2 (2**30 u8 counters = 1 GiB): h loads and at most h
// reductions per frame, plus the coalesced read of the positions and of c.
// Each reduction lands in L2 on the sector its load brought in, and the
// dirty sector is written back later, so a written counter costs DRAM a
// random read and a random write-back: measured, about three times the
// read-only gather of the same positions. Design: one thread per frame, the
// position loads coalesced across the warp (plane-major [h, m]); all h word
// loads are issued before any of them is used, from registers, so a frame
// waits for one DRAM round trip instead of h (unrolled up to H_MAX slots;
// above that a loop keeps the lanes in a scratch array [h, m] that the
// wrapper allocates). A frame whose slot 0 is the sentinel loads nothing.
//
// Semantics: a sentinel slot reads 0 and writes nothing; a word index past
// the array is read from the last word (clamped, as the gather is) and
// written nowhere. Positions are uint32 with the sentinel 0xFFFFFFFF below
// 2**32 counters; a filter of exactly 2**32 counters takes wide positions,
// int64 with -1 the sentinel, through instantiations of their own.

#include "common.cuh"

#define H_MAX 8

struct Lanes {
    unsigned bits;
    unsigned mask;
    uint32_t sub_mask;
    int shift;
    long long nwords;

    __device__ Lanes(int shift_, long long nwords_)
        : bits(32u >> shift_),
          mask((32u >> shift_) == 32 ? 0xFFFFFFFFu
                                     : (1u << (32u >> shift_)) - 1u),
          sub_mask((1u << shift_) - 1u), shift(shift_), nwords(nwords_) {}

    template <typename P>
    __device__ long long word(P p) const {
        const long long w = (long long)(p >> shift);
        return w < nwords ? w : nwords - 1;
    }
    template <typename P>
    __device__ unsigned lane_shift(P p) const {
        return ((uint32_t)p & sub_mask) * bits;
    }
};

// target = mn + min(c, counter_max - mn), in 64 bits (width 4 has
// counter_max = 2**32 - 1; a negative c gives a target below mn, which
// writes nothing).
__device__ __forceinline__ long long step_target(uint32_t mn, long long c,
                                                 uint32_t counter_max) {
    const long long head = (long long)counter_max - (long long)mn;
    return (long long)mn + (c < head ? c : head);
}

template <typename P>
__device__ __forceinline__ void lane_add(unsigned int* words,
                                         const Lanes& L, P p,
                                         uint32_t cur, long long target) {
    if (btl_is_sentinel(p) || (long long)(p >> L.shift) >= L.nwords) return;
    if ((long long)cur >= target) return;
    // carry-free: cur < target <= counter_max, and no other thread adds to
    // this lane in this step (see the note above)
    atomicAdd(&words[p >> L.shift],
              (unsigned int)(target - (long long)cur) << L.lane_shift(p));
}

// P: uint32_t, or long long for wide positions.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
conservative_step_regs(const P* __restrict__ pos,
                       const long long* __restrict__ c, long long m, int h,
                       unsigned int* words, long long nwords, int shift,
                       uint32_t counter_max) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m || btl_is_sentinel(pos[i])) return;
    const Lanes L(shift, nwords);
    P p[H_MAX];
    uint32_t v[H_MAX];
#pragma unroll
    for (int j = 0; j < H_MAX; ++j)
        if (j < h) p[j] = pos[(long long)j * m + i];
    // every load issued before any is used
#pragma unroll
    for (int j = 0; j < H_MAX; ++j)
        if (j < h) v[j] = btl_is_sentinel(p[j]) ? 0u : words[L.word(p[j])];
    uint32_t mn = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < H_MAX; ++j) {
        if (j < h) {
            if (!btl_is_sentinel(p[j]))
                v[j] = (v[j] >> L.lane_shift(p[j])) & L.mask;
            mn = v[j] < mn ? v[j] : mn;
        }
    }
    const long long target = step_target(mn, c[i], counter_max);
#pragma unroll
    for (int j = 0; j < H_MAX; ++j) {
        if (j >= h) continue;
        bool dup = false;
#pragma unroll
        for (int k = 0; k < j; ++k) dup |= p[k] == p[j];
        if (!dup) lane_add(words, L, p[j], v[j], target);
    }
}

// h > H_MAX: the same step, the lanes kept in scratch [h, m] (coalesced);
// the word loads of each group of H_MAX slots are issued together.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
conservative_step_loop(const P* __restrict__ pos,
                       const long long* __restrict__ c, long long m, int h,
                       unsigned int* words, long long nwords, int shift,
                       uint32_t counter_max, uint32_t* __restrict__ scratch) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m || btl_is_sentinel(pos[i])) return;
    const Lanes L(shift, nwords);
    uint32_t mn = 0xFFFFFFFFu;
    for (int j0 = 0; j0 < h; j0 += H_MAX) {
        P p[H_MAX];
        uint32_t v[H_MAX];
#pragma unroll
        for (int j = 0; j < H_MAX; ++j)
            if (j0 + j < h) p[j] = pos[(long long)(j0 + j) * m + i];
#pragma unroll
        for (int j = 0; j < H_MAX; ++j)
            if (j0 + j < h)
                v[j] = btl_is_sentinel(p[j]) ? 0u : words[L.word(p[j])];
#pragma unroll
        for (int j = 0; j < H_MAX; ++j) {
            if (j0 + j < h) {
                if (!btl_is_sentinel(p[j]))
                    v[j] = (v[j] >> L.lane_shift(p[j])) & L.mask;
                mn = v[j] < mn ? v[j] : mn;
                scratch[(long long)(j0 + j) * m + i] = v[j];
            }
        }
    }
    const long long target = step_target(mn, c[i], counter_max);
    for (int j = 0; j < h; ++j) {
        const P pj = pos[(long long)j * m + i];
        bool dup = false;
        for (int k = 0; k < j && !dup; ++k)
            dup = pos[(long long)k * m + i] == pj;
        if (!dup) lane_add(words, L, pj, scratch[(long long)j * m + i],
                           target);
    }
}

template <typename P>
static int launch(const void* pos, const void* c, long long m, int h,
                  void* words, long long nwords, int shift,
                  unsigned int counter_max, void* scratch, int device,
                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (h < 1 || (h > H_MAX && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((m + BTL_BLOCK - 1) / BTL_BLOCK);
    if (h <= H_MAX)
        conservative_step_regs<P><<<blocks, BTL_BLOCK, 0,
                                    (cudaStream_t)stream>>>(
            (const P*)pos, (const long long*)c, m, h, (unsigned int*)words,
            nwords, shift, counter_max);
    else
        conservative_step_loop<P><<<blocks, BTL_BLOCK, 0,
                                    (cudaStream_t)stream>>>(
            (const P*)pos, (const long long*)c, m, h, (unsigned int*)words,
            nwords, shift, counter_max, (uint32_t*)scratch);
    return (int)cudaGetLastError();
}

// pos uint32 [h, m] plane-major (frames position-disjoint); c int64 [m];
// words uint32 [nwords], updated in place; scratch uint32 [h, m] when
// h > H_MAX, else unused (may be null).
extern "C" int btl_conservative_step(const void* pos, const void* c,
                                     long long m, int h, void* words,
                                     long long nwords, int shift,
                                     unsigned int counter_max, void* scratch,
                                     int device, void* stream) {
    return launch<uint32_t>(pos, c, m, h, words, nwords, shift, counter_max,
                            scratch, device, stream);
}

// The same for wide positions: pos int64 [h, m], -1 the sentinel.
extern "C" int btl_conservative_step_wide(const void* pos, const void* c,
                                          long long m, int h, void* words,
                                          long long nwords, int shift,
                                          unsigned int counter_max,
                                          void* scratch, int device,
                                          void* stream) {
    return launch<long long>(pos, c, m, h, words, nwords, shift,
                             counter_max, scratch, device, stream);
}
