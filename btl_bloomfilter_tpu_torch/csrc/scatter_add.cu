// Counting-filter update: counters[p] = min(counters[p] + inc, counter_max)
// for every (position, increment) pair, in place on packed counters (lane
// p & (per-1) of 32-bit word p >> shift, per = 1 << shift). Positions come
// in any order, with duplicates; the sentinel 0xFFFFFFFF, a zero increment
// and a word index past the array are no-ops. With no increment array
// every pair adds 1 (incrementAll). A filter of exactly 2**32 counters
// (0xFFFFFFFF a real counter) takes wide positions, int64 with -1 the
// sentinel (entry points of their own), on the direct or the sparse
// route; the tiled route cannot take such a filter: its 2**30 words or
// more make 65,536 tiles, past the partition's 32,768.
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
// The new lane value is computed in 64 bits and clamped at counter_max
// before it is put back in its lane, so a sum never carries into the
// neighbouring lane; a lane already at counter_max is left alone without a
// CAS. Saturating adds of non-negative increments compose in any order:
// min(min(c + a, M) + b, M) = min(c + a + b, M). Two routes
// (kernels/scatter_add.py picks one by the array's words and the number of
// pairs):
//   direct: one thread per pair in a grid-stride loop with coalesced pair
//     loads, the CAS in L2;
//   tiled, unit increments only (incrementAll): the tile partition
//     (tile_partition.cu) groups the positions by 64 KiB tile of the
//     array; then one block a non-empty tile loads the tile into shared
//     memory with 16-byte loads, adds 1 to each of its positions with the
//     same clamped CAS on shared memory, and writes the tile back: a full
//     sweep of the array in address order. The other design measured (the
//     direct body over the grouped positions, blocks dispatched in order
//     so the lines in flight stay in L2) was slower at the counting batch
//     (PERF.md);
//   sparse, unit increments of wide positions only, past the
//     partition's BTL_MAX_TILES tiles (a filter of 2**32 u8 counters has
//     65,536): the partition groups the positions by coarse tile
//     (tile_partition.cuh), then one block a coarse tile sorts its
//     positions in shared memory and makes one clamped CAS a distinct
//     word, every lane's run of equal counters added at once (saturating
//     adds compose), in address order. No tile
//     copy: at a few hundred pairs a 64 KiB tile, the tiled route's sweep
//     (8 GiB at 2**32 counters) would cost more than the direct route.
//     Both routes are bound by the DRAM sectors a CAS reads and writes
//     back; in address order, with the blocks in flight inside a few
//     hundred MB of the array, the card moves them faster, enough to pay
//     for the partition from a pair a 128 words (PERF.md: bench.py's
//     counting batch into 2**32 counters a quarter faster).

#include "tile_partition.cuh"

// counters[p] = min(counters[p] + c, counter_max) on the word at addr
// (global or shared), the lane at bit sh of lane_mask's width.
__device__ __forceinline__ void sat_add(unsigned int* addr, unsigned sh,
                                        uint32_t lane_mask, uint32_t c,
                                        uint32_t counter_max) {
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

// P: uint32_t, or long long for wide positions.
template <typename P>
__global__ void __launch_bounds__(BTL_BLOCK)
scatter_add_kernel(const P* __restrict__ pos,
                   const uint32_t* __restrict__ inc, long long n,
                   unsigned int* __restrict__ words, long long nwords,
                   int shift, uint32_t counter_max) {
    const unsigned bits = 32u >> shift;
    const unsigned lane_mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    const uint32_t sub_mask = (1u << shift) - 1u;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const P p = pos[i];
        if (btl_is_sentinel(p)) continue;
        const uint32_t c = inc ? inc[i] : 1u;
        if (c == 0) continue;
        const long long w = (long long)(p >> shift);
        if (w >= nwords) continue;
        sat_add(&words[w], ((uint32_t)p & sub_mask) * bits, lane_mask, c,
                counter_max);
    }
}

// The tiled route's apply: block t loads tile t into shared memory, adds
// 1 at each of its positions there, and writes it back. Each tile has one
// block, so the array needs no global atomic.
__global__ void __launch_bounds__(BTL_TILE_THREADS)
scatter_add_tile_kernel(const uint32_t* __restrict__ pos,
                        const uint32_t* __restrict__ offsets,
                        unsigned int* __restrict__ words, long long nwords,
                        int shift, uint32_t counter_max) {
    extern __shared__ uint4 tile4[];
    uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
    const long long t = blockIdx.x;
    const uint32_t lo = offsets[t], hi = offsets[t + 1];
    if (lo == hi) return;
    const long long w0 = t << BTL_TILE_SHIFT;
    const int len = (int)(nwords - w0 < BTL_TILE_WORDS ? nwords - w0
                                                        : BTL_TILE_WORDS);
    btl_tile_copy<true>(tile, words + w0, len);
    __syncthreads();
    const unsigned bits = 32u >> shift;
    const unsigned lane_mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    const uint32_t sub_mask = (1u << shift) - 1u;
    for (uint32_t i0 = lo + threadIdx.x; i0 < hi; i0 += 4 * blockDim.x) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t i = i0 + j * blockDim.x;
            p[j] = i < hi ? pos[i] : BTL_SENTINEL;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (p[j] != BTL_SENTINEL)
                sat_add(&tile[(p[j] >> shift) - w0], (p[j] & sub_mask) * bits,
                        lane_mask, 1u, counter_max);
    }
    __syncthreads();
    btl_tile_copy<false>(tile, words + w0, len);
}

// Each lane l of the word at addr with cnt[l] > 0 (l < 1 << shift) set to
// min(lane + cnt[l], counter_max), lanes at counter_max or above left
// alone, in one CAS (retried while another thread changes the word).
__device__ __forceinline__ void sat_add_lanes(unsigned int* addr,
                                              const uint32_t (&cnt)[4],
                                              int shift,
                                              uint32_t counter_max) {
    const unsigned bits = 32u >> shift;
    const unsigned lane_mask = bits == 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
    unsigned int old = *((volatile unsigned int*)addr);
    while (true) {
        unsigned int upd = old;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
            if (l >= (1 << shift) || cnt[l] == 0) continue;
            const unsigned sh = l * bits;
            const uint32_t lane = (old >> sh) & lane_mask;
            if (lane >= counter_max) continue;
            unsigned long long nl = (unsigned long long)lane + cnt[l];
            if (nl > counter_max) nl = counter_max;
            upd = (upd & ~(lane_mask << sh)) | ((uint32_t)nl << sh);
        }
        if (upd == old) break;
        const unsigned int seen = atomicCAS(addr, old, upd);
        if (seen == old) break;
        old = seen;
    }
}

// The sparse route's apply: block t takes coarse tile t's grouped
// positions (tile t spans 2**tile_shift words from word t << tile_shift;
// each entry holds a position's low 32 bits), BTL_SPARSE_KEYS at a time,
// sorts them, and adds each distinct word's lane counts in one clamped
// CAS, in address order. Words past the array are dropped here (the
// partition only drops past the last coarse word).
__global__ void __launch_bounds__(BTL_SPARSE_THREADS)
scatter_add_sparse_kernel(const uint32_t* __restrict__ grouped,
                          const uint32_t* __restrict__ offsets,
                          unsigned int* __restrict__ words, long long nwords,
                          int shift, int tile_shift, uint32_t counter_max) {
    __shared__ uint32_t s[BTL_SPARSE_KEYS];
    const long long t = blockIdx.x;
    const uint32_t lo = offsets[t], hi = offsets[t + 1];
    const long long w0 = t << tile_shift;
    const uint32_t sub_mask = (1u << shift) - 1u;
    for (uint32_t c = lo; c < hi; c += BTL_SPARSE_KEYS) {
        const int n = hi - c < BTL_SPARSE_KEYS ? (int)(hi - c)
                                               : BTL_SPARSE_KEYS;
        btl_sparse_sort(grouped, c, n, tile_shift + shift, s);
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const uint32_t w = s[i] >> shift;
            if (i > 0 && (s[i - 1] >> shift) == w) continue;  // not its head
            uint32_t cnt[4] = {0, 0, 0, 0};
            for (int j = i; j < n && (s[j] >> shift) == w;) {
                const int e = btl_run_end(s, j, n);
                const uint32_t lane = s[j] & sub_mask;
#pragma unroll
                for (int l = 0; l < 4; ++l)
                    if (l == (int)lane) cnt[l] += (uint32_t)(e - j);
                j = e;
            }
            if (w0 + w < nwords)
                sat_add_lanes(&words[w0 + w], cnt, shift, counter_max);
        }
        __syncthreads();        // the next chunk overwrites s
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

// The same for wide positions: pos int64 [n], -1 the sentinel.
extern "C" int btl_scatter_add_wide(const void* pos, const void* inc,
                                    long long n, void* words,
                                    long long nwords, int shift,
                                    unsigned int counter_max, int device,
                                    void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const long long*)pos, (const uint32_t*)inc, n,
        (unsigned int*)words, nwords, shift, counter_max);
    return (int)cudaGetLastError();
}

// The tiled route of unit increments: partition, then apply, all on the
// given stream. Arguments as btl_scatter_add's with inc null, scratch as
// btl_tile_partition_run takes it.
extern "C" int btl_scatter_add_tiled(const void* pos, long long n,
                                     void* words, long long nwords,
                                     int shift, unsigned int counter_max,
                                     void* scratch, int device,
                                     void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    err = btl_tile_partition_run((const uint32_t*)pos, n, nwords, shift,
                                 (uint32_t*)scratch, st);
    if (err != cudaSuccess || n == 0) return (int)err;
    static unsigned long long smem_set = 0;
    err = btl_allow_smem(scatter_add_tile_kernel,
                         BTL_TILE_WORDS * sizeof(uint32_t), device,
                         &smem_set);
    if (err != cudaSuccess) return (int)err;
    const BtlTileScratch s = btl_tile_scratch((uint32_t*)scratch, n, nwords);
    scatter_add_tile_kernel<<<(unsigned)btl_ntiles(nwords),
                              BTL_TILE_THREADS,
                              BTL_TILE_WORDS * sizeof(uint32_t), st>>>(
        s.pos, s.offsets, (unsigned int*)words, nwords, shift,
        counter_max);
    return (int)cudaGetLastError();
}

// The sparse route of unit increments, for wide positions (pos int64 [n],
// -1 the sentinel): the partition on coarse tiles (2**extra words a
// coarse word), then the apply, on the given stream. Other arguments as
// btl_scatter_add_wide's with inc null; extra the coarse tile's words as a
// shift past BTL_TILE_SHIFT; scratch as btl_tile_partition_run takes it
// for n positions into btl_coarse_words(nwords, extra) words.
extern "C" int btl_scatter_add_sparse_wide(const void* pos, long long n,
                                           void* words, long long nwords,
                                           int shift,
                                           unsigned int counter_max,
                                           int extra, void* scratch,
                                           int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (extra < 0 || shift + BTL_TILE_SHIFT + extra > 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long coarse = btl_coarse_words(nwords, extra);
    err = btl_tile_partition_run_wide((const long long*)pos, n, coarse,
                                      shift + extra, (uint32_t*)scratch, st);
    if (err != cudaSuccess || n == 0) return (int)err;
    const BtlTileScratch s = btl_tile_scratch((uint32_t*)scratch, n, coarse);
    scatter_add_sparse_kernel<<<(unsigned)btl_ntiles(coarse),
                                BTL_SPARSE_THREADS, 0, st>>>(
        s.pos, s.offsets, (unsigned int*)words, nwords, shift,
        BTL_TILE_SHIFT + extra, counter_max);
    return (int)cudaGetLastError();
}
