// Bloom insert of SORTED bit positions: words[p >> 5] |= 1 << (p & 31),
// in place with one atomicOr per run of equal words in a warp instead of
// one per position; and the same insert into a new array, words_out =
// words_in | bits(pos), in one streaming sweep.
//
// Replaces two TPU kernels:
//   btl_bloomfilter_tpu/kernels/scatter_or.py:scatter_or_sorted (_kernel,
//     pallas_call at :158): a 16384-word window read-modify-written per
//     1024-position chunk, the window's delta built as an MXU one-hot
//     product; here the in place form (kernels/scatter_or.py);
//   btl_bloomfilter_tpu/kernels/scatter_ring.py:scatter_or_sorted
//     (_kernel, pallas_call at :234): the same histogram accumulated in a
//     VMEM ring of slots and flushed into a zeros delta array, which the
//     JAX function ORs into the filter as a new array; here the delta form
//     (kernels/scatter_ring.py).
// Both need sorted, deduplicated positions so a chunk fits a window, and
// count the positions that overflow it for the caller to re-apply. On
// Hopper every position is applied and the overflow is always 0.
//
// The in place form. What bounds it on the H100: the 4-byte
// read-modify-writes into a filter larger than the 50 MB L2 (2**30 bits =
// 128 MiB): an L2 miss fetches 64 bytes (the card's L2 fetch granularity)
// and a written sector goes back whole, so the floor is the positions
// plus 128 bytes a distinct 64-byte block. Design: the sort is exploited,
// not required. One thread per position, over a grid sized to the
// positions (no grid-stride loop: every position's load is in flight at
// once, streamed evict-first); warp shuffles mark runs of equal word
// index (a run head is lane 0 or a word different from the lane before),
// a segmented OR scan folds each run's masks, and the run's last lane
// issues the one atomicOr, so a warp's atomics go to the words of 32
// consecutive sorted positions. Sentinels (0xFFFFFFFF) and positions past
// nwords form runs of their own that issue nothing. Duplicates replaced by
// sentinels in place break the monotone order; a sentinel inside a run
// splits it into two atomics on one word, which is still exact: OR
// commutes, so the result never depends on the run detection. Measured
// and not kept (PERF.md): a tile-owned read-modify-write after the delta
// form's range pass, four or eight positions a thread by 16-byte loads,
// two or four rows of positions a thread with their loads first, and one
// atomic a position without the scan.

// The delta form. What bounds it: the whole filter read once and a new one
// written once (2 x 128 MiB at 2**30 bits) plus the positions; the three
// passes it replaced (a zeros delta written, the atomics into it, then
// words | delta) moved 640 MiB. Design, in one call on one stream: a
// memset and a range pass record, for each 64 KiB tile of the output, the
// first and the last index of the positions that fall in it (one
// atomicMin pair per tile a warp meets, lanes grouped by __match_any_sync);
// then one block a tile starts the tile's copy from words_in into shared
// memory (tile_stream.cuh), loads the positions of the tile's index range
// while it is in flight, ORs in those of its tile (shared atomicOr) and
// stores the tile to words_out. A tile's range holds all of its positions
// whatever their order, so the result is exact for any order, duplicates
// and sentinels; only the time depends on the order: sorted positions
// give disjoint ranges, each read once, while unsorted ones give every
// tile a range across the batch. Measured and not kept (PERF.md): a
// persistent grid streaming tiles through a ring of three buffers, a range
// pass that carries a warp's tile across a span, a launch that overlaps
// the range pass (programmatic dependent launch), three blocks an SM
// forced by the register bound.

#include "tile_stream.cuh"

#define BTL_FULL_MASK 0xFFFFFFFFu

__global__ void __launch_bounds__(BTL_BLOCK)
scatter_or_sorted_kernel(const uint32_t* __restrict__ pos, long long n,
                         unsigned int* __restrict__ words,
                         long long nwords) {
    const int lane = threadIdx.x & 31;
    // one position a thread; the threads past n take part in the shuffles
    const long long i = (long long)blockIdx.x * BTL_BLOCK + threadIdx.x;
    int w = -1;                     // word index; -1 applies nothing
    unsigned int m = 0;
    if (i < n) {
        const uint32_t p = __ldcs(pos + i);
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

// pos uint32 [n] (sorted for one atomic per run; any order is exact);
// words uint32 [nwords], updated in place.
extern "C" int btl_scatter_or_sorted(const void* pos, long long n,
                                     void* words, long long nwords,
                                     int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess || n <= 0) return (int)err;
    scatter_or_sorted_kernel<<<(unsigned)((n + BTL_BLOCK - 1) / BTL_BLOCK),
                               BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pos, n, (unsigned int*)words, nwords);
    return (int)cudaGetLastError();
}

// The delta form's range words sit a 128-byte line apart, so that the
// atomics of the range pass on different tiles spread over L2's slices.
#define BTL_RANGE_STRIDE 32
#define BTL_RANGE_UNROLL 4            // positions in flight a thread

// The delta form's range pass: first[t] = the least index of a live
// position in tile t, neglast[t] = ~(the greatest), both atomicMin into
// words the caller set to 0xFFFFFFFF (an empty tile keeps first >
// ~neglast); entry t at t * BTL_RANGE_STRIDE. Lanes of a warp with the
// same tile elect its lowest lane for first and its highest for the last
// index.
__global__ void __launch_bounds__(BTL_BLOCK)
sorted_delta_ranges(const uint32_t* __restrict__ pos, long long n,
                    long long nwords, unsigned int* __restrict__ first,
                    unsigned int* __restrict__ neglast) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
         base += BTL_RANGE_UNROLL * stride) {
        uint32_t p[BTL_RANGE_UNROLL];
#pragma unroll
        for (int j = 0; j < BTL_RANGE_UNROLL; ++j) {
            const long long i = base + j * stride + threadIdx.x;
            p[j] = i < n ? pos[i] : BTL_SENTINEL;
        }
#pragma unroll
        for (int j = 0; j < BTL_RANGE_UNROLL; ++j) {
            const long long i = base + j * stride + threadIdx.x;
            int t = -1;
            if (p[j] != BTL_SENTINEL && (long long)(p[j] >> 5) < nwords)
                t = (int)((p[j] >> 5) >> BTL_TILE_SHIFT);
            const unsigned same = __match_any_sync(BTL_FULL_MASK, t);
            if (t >= 0) {
                if (lane == __ffs(same) - 1)
                    atomicMin(&first[t * BTL_RANGE_STRIDE], (unsigned int)i);
                if (lane == 31 - __clz(same))
                    atomicMin(&neglast[t * BTL_RANGE_STRIDE],
                              ~(unsigned int)i);
            }
        }
    }
}

#define BTL_DELTA_UNROLL 4            // position vectors in flight a thread

// The delta form's sweep, one block a tile: the tile's copy starts
// (cp.async); while it is in flight the block reads the tile's index
// range [first, last] and loads its positions, 16 bytes a load (the
// vectors that cover the range, the positions outside it masked); then
// ORs in those that fall in the tile and stores it to words_out.
__global__ void __launch_bounds__(BTL_TILE_THREADS)
sorted_delta_tile(const uint32_t* __restrict__ pos, long long n,
                  const unsigned int* __restrict__ first,
                  const unsigned int* __restrict__ neglast,
                  const uint32_t* __restrict__ words_in,
                  uint32_t* __restrict__ words_out, long long nwords) {
    extern __shared__ uint4 tile4[];
    uint32_t* s = reinterpret_cast<uint32_t*>(tile4);
    const long long t = blockIdx.x;
    const int len = btl_tile_len(t, nwords);
    btl_stream_load(s, words_in + (t << BTL_TILE_SHIFT), len);
    const long long lo = first[t * BTL_RANGE_STRIDE];
    const long long hi = ~neglast[t * BTL_RANGE_STRIDE];
    const long long w0 = t << BTL_TILE_SHIFT;
    const uint4* pos4 = reinterpret_cast<const uint4*>(pos);
    bool arrived = false;
    // vectors lo / 4 .. hi / 4 in rounds of the block's loads in flight;
    // the trip count is the block's, so the barrier inside is uniform
    for (long long b = lo >> 2; b <= hi >> 2;
         b += BTL_DELTA_UNROLL * blockDim.x) {
        uint4 q[BTL_DELTA_UNROLL];
#pragma unroll
        for (int j = 0; j < BTL_DELTA_UNROLL; ++j) {
            const long long v = b + threadIdx.x + j * blockDim.x;
            q[j] = make_uint4(BTL_SENTINEL, BTL_SENTINEL, BTL_SENTINEL,
                              BTL_SENTINEL);
            if (4 * v + 3 < n) {
                if (v <= hi >> 2) q[j] = pos4[v];
            } else if (v <= hi >> 2) {      // the last, partial vector
                if (4 * v < n) q[j].x = pos[4 * v];
                if (4 * v + 1 < n) q[j].y = pos[4 * v + 1];
                if (4 * v + 2 < n) q[j].z = pos[4 * v + 2];
            }
        }
        if (!arrived) {             // the tile is in
            btl_cp_async_wait<0>();
            __syncthreads();
            arrived = true;
        }
#pragma unroll
        for (int j = 0; j < BTL_DELTA_UNROLL; ++j) {
            const long long i0 = 4 * (b + threadIdx.x + j * blockDim.x);
            const uint32_t p[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const long long local = (long long)(p[k] >> 5) - w0;
                if (i0 + k >= lo && i0 + k <= hi && p[k] != BTL_SENTINEL
                    && local >= 0 && local < len)
                    atomicOr(&s[local], 1u << (p[k] & 31));
            }
        }
    }
    if (!arrived) btl_cp_async_wait<0>();
    __syncthreads();
    btl_tile_copy<false>(s, words_out + (t << BTL_TILE_SHIFT), len);
}

// Words of the delta form's scratch for an array of nwords words: the
// padded range words of every tile.
extern "C" long long btl_scatter_or_sorted_delta_scratch(long long nwords) {
    return 2 * BTL_RANGE_STRIDE * btl_ntiles(nwords);
}

// pos uint32 [n] (any order; sorted for disjoint tile ranges), 16-byte
// aligned, n < 2**31; words_in uint32 [nwords], read only; words_out
// uint32 [nwords], written whole, not overlapping words_in; scratch as
// btl_scatter_or_sorted_delta_scratch sizes it.
extern "C" int btl_scatter_or_sorted_delta(const void* pos, long long n,
                                           const void* words_in,
                                           void* words_out, long long nwords,
                                           void* scratch, int device,
                                           void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    const long long ntiles = btl_ntiles(nwords);
    unsigned int* first = (unsigned int*)scratch;
    unsigned int* neglast = first + ntiles * BTL_RANGE_STRIDE;
    err = cudaMemsetAsync(
        scratch, 0xFF,
        btl_scatter_or_sorted_delta_scratch(nwords) * sizeof(uint32_t), st);
    if (err != cudaSuccess) return (int)err;
    if (n > 0) {
        sorted_delta_ranges<<<btl_blocks(n), BTL_BLOCK, 0, st>>>(
            (const uint32_t*)pos, n, nwords, first, neglast);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    static unsigned long long smem_set = 0;
    err = btl_allow_smem(sorted_delta_tile, BTL_TILE_WORDS * 4, device,
                         &smem_set);
    if (err != cudaSuccess) return (int)err;
    sorted_delta_tile<<<(unsigned)ntiles, BTL_TILE_THREADS,
                        BTL_TILE_WORDS * 4, st>>>(
        (const uint32_t*)pos, n, first, neglast, (const uint32_t*)words_in,
        (uint32_t*)words_out, nwords);
    return (int)cudaGetLastError();
}
