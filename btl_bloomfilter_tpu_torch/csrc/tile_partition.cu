// Tile partition: the live positions of a batch grouped by the tile of the
// array they write, with the per-tile offsets. The order inside a tile is
// free. It is the first stage of the tiled scatters (scatter_or.cu,
// scatter_add.cu), and a kernel of its own (btl_tile_partition).
//
// Replaces: the full sort that put positions in order ahead of the TPU's
// window scatters (btl_bloomfilter_tpu/models/bloom.py:209 ahead of
// kernels/scatter_ring.py:480, models/counting.py:1094 ahead of
// kernels/scatter_add.py:194). A tile of the array only has to be small
// enough that the tiles in flight sit in L2 or in shared memory, so a
// counting sort on the tile index replaces the sort: no dedupe, no order
// inside a tile.
//
// What bounds it on the H100: the bytes it streams. A one-pass counting
// sort into thousands of tiles does not stream: each block's run in each
// tile is a few positions long, so the writes scatter into millions of
// partly written sectors (the first design, one pass with a shared
// histogram of every tile, took 0.086 ms for the Bloom batch and 1.66 ms
// for the counting batch; PERF.md). Design: a most-significant-digit
// counting sort of at most two passes of at most 256 buckets each (the
// tile index's high bits, then its low 7 bits inside each high bucket).
// Each pass is three launches: count (each block histograms its part of a
// segment in shared memory, one global atomic per block and bucket keeps
// the block's base inside the bucket), scan (one block), and scatter: each
// block ranks 4096 positions at a time in shared memory, stages them there
// grouped by bucket, and writes each bucket's run with consecutive threads
// on consecutive addresses, the next 4096 positions loading meanwhile.
// Runs average 16-32 positions, so the writes leave the L2 as whole
// sectors. The sentinel and positions past the array are dropped in the
// first pass.

#include "tile_partition.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BUCKETS = 256;
// positions a scatter block ranks and stages at a time
constexpr int STAGE = 4096;
constexpr int ITEMS = STAGE / THREADS;
// at most this many blocks a pass (four on each of 132 SMs)
constexpr int MAX_BLOCKS = 528;
// low bits of the tile index sorted by the second pass
constexpr int LOW_BITS = 7;

struct Pass {
    const uint32_t* keys;     // positions in
    const uint32_t* seg;      // segment offsets [nseg + 1], or null: one
                              // segment [0, n)
    long long n;
    int per_seg;              // blocks a segment
    long long nwords;         // live filter (first pass only: filter != 0)
    int filter;
    int word_shift;
    int digit_shift;          // bucket = (tile >> digit_shift) & (B - 1)
    int buckets;              // B, a power of two <= 256
    uint32_t* counts;         // [nseg * B], zeroed; scanned to offsets
    uint32_t* hist;           // [grid * B], each block's base in a bucket
    uint32_t* out;            // positions out
};

// This block's part [lo, hi) of its segment.
__device__ __forceinline__ void block_range(const Pass& P, int* seg,
                                            long long* lo, long long* hi) {
    const int s = blockIdx.x / P.per_seg, part = blockIdx.x % P.per_seg;
    const long long a = P.seg ? P.seg[s] : 0;
    const long long b = P.seg ? P.seg[s + 1] : P.n;
    const long long len = (b - a + P.per_seg - 1) / P.per_seg;
    *seg = s;
    *lo = a + part * len < b ? a + part * len : b;
    *hi = *lo + len < b ? *lo + len : b;
}

// The bucket of position p, or -1 where the first pass drops it.
__device__ __forceinline__ int bucket(const Pass& P, uint32_t p) {
    const long long w = (long long)(p >> P.word_shift);
    if (P.filter && (p == BTL_SENTINEL || w >= P.nwords)) return -1;
    return (int)((w >> BTL_TILE_SHIFT) >> P.digit_shift) & (P.buckets - 1);
}

__global__ void __launch_bounds__(THREADS) tp_count(Pass P) {
    // one histogram a warp: the atomics of a warp contend only among its
    // own lanes
    __shared__ uint32_t s_hist[WARPS][MAX_BUCKETS];
    const int warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < WARPS * MAX_BUCKETS; i += THREADS)
        (&s_hist[0][0])[i] = 0;
    __syncthreads();
    int seg;
    long long lo, hi;
    block_range(P, &seg, &lo, &hi);
    for (long long i0 = lo + threadIdx.x; i0 < hi;
         i0 += (long long)ITEMS * THREADS) {
        uint32_t p[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const long long i = i0 + (long long)j * THREADS;
            p[j] = i < hi ? P.keys[i] : 0u;
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (i0 + (long long)j * THREADS >= hi) break;
            const int d = bucket(P, p[j]);
            if (d >= 0) atomicAdd(&s_hist[warp][d], 1u);
        }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < P.buckets; d += THREADS) {
        uint32_t c = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) c += s_hist[w][d];
        if (c)
            P.hist[(long long)blockIdx.x * P.buckets + d] =
                atomicAdd(&P.counts[(long long)seg * P.buckets + d], c);
    }
}

// counts [m] -> exclusive offsets in place, offsets[m] = total. One block
// of 1024 threads; each scans a run of consecutive entries.
__global__ void __launch_bounds__(1024) tp_scan(uint32_t* offsets, int m) {
    __shared__ uint32_t warp_total[32];
    const int per = (m + 1023) / 1024;
    const int first = threadIdx.x * per;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t sum = 0;
    for (int j = 0; j < per; ++j)
        if (first + j < m) sum += offsets[first + j];
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t v = warp_total[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, v, d);
            if (lane >= d) v += u;
        }
        warp_total[lane] = v;
    }
    __syncthreads();
    uint32_t run = incl - sum + (warp ? warp_total[warp - 1] : 0u);
    for (int j = 0; j < per; ++j) {
        if (first + j < m) {
            const uint32_t c = offsets[first + j];
            offsets[first + j] = run;
            run += c;
        }
    }
    if (threadIdx.x == 1023) offsets[m] = run;
}

// Load the STAGE positions from base on, a thread's ITEMS strided by
// THREADS.
__device__ __forceinline__ void load_stage(const Pass& P, long long base,
                                           long long hi, uint32_t* p) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const long long i = base + threadIdx.x + (long long)j * THREADS;
        p[j] = i < hi ? P.keys[i] : 0u;
    }
}

__global__ void __launch_bounds__(THREADS) tp_scatter(Pass P) {
    __shared__ uint32_t s_keys[STAGE];
    __shared__ uint32_t s_count[MAX_BUCKETS];   // this stage's, per bucket
    __shared__ uint32_t s_start[MAX_BUCKETS];   // its exclusive scan
    __shared__ uint32_t s_next[MAX_BUCKETS];    // the block's next slot
    __shared__ uint32_t warp_total[WARPS];
    __shared__ uint32_t s_live;
    int seg;
    long long lo, hi;
    block_range(P, &seg, &lo, &hi);
    const int B = P.buckets;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = threadIdx.x; d < B; d += THREADS)
        s_next[d] = P.counts[(long long)seg * B + d] +
                    P.hist[(long long)blockIdx.x * B + d];
    uint32_t p[ITEMS];
    load_stage(P, lo, hi, p);
    for (long long base = lo; base < hi; base += STAGE) {
        for (int d = threadIdx.x; d < B; d += THREADS) s_count[d] = 0;
        __syncthreads();
        uint32_t rank[ITEMS];
        int dig[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const long long i = base + threadIdx.x + (long long)j * THREADS;
            dig[j] = i < hi ? bucket(P, p[j]) : -1;
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            rank[j] = dig[j] >= 0 ? atomicAdd(&s_count[dig[j]], 1u) : 0u;
        __syncthreads();
        // exclusive scan of the stage's counts (B <= 256 < THREADS)
        const uint32_t c = threadIdx.x < B ? s_count[threadIdx.x] : 0u;
        uint32_t incl = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
            if (lane >= d) incl += u;
        }
        if (lane == 31) warp_total[warp] = incl;
        __syncthreads();
        uint32_t before = 0;
        for (int w = 0; w < warp; ++w) before += warp_total[w];
        if (threadIdx.x < B) s_start[threadIdx.x] = before + incl - c;
        if (threadIdx.x == B - 1) s_live = before + incl;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (dig[j] >= 0) s_keys[s_start[dig[j]] + rank[j]] = p[j];
        }
        // the next stage's loads fly while this one is written out
        load_stage(P, base + STAGE, hi, p);
        __syncthreads();
        // each bucket's run, consecutive threads on consecutive addresses
        const uint32_t live = s_live;
        for (uint32_t i = threadIdx.x; i < live; i += THREADS) {
            const uint32_t key = s_keys[i];
            const int d = bucket(P, key);
            P.out[s_next[d] + (i - s_start[d])] = key;
        }
        __syncthreads();
        for (int d = threadIdx.x; d < B; d += THREADS) s_next[d] += s_count[d];
    }
}

int ceil_log2(long long x) {
    int b = 0;
    while ((1LL << b) < x) ++b;
    return b;
}

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

// The scratch of a partition, laid out as BtlTileScratch says.
struct Plan {
    int tile_bits, high_bits, low_bits;   // low_bits 0: one pass
    long long padded;                     // 2**tile_bits tiles
    int grid1, grid2, per_seg2;
    long long hist_words;
};

Plan plan(long long n, long long nwords) {
    Plan p;
    p.tile_bits = ceil_log2(btl_ntiles(nwords));
    p.padded = 1LL << p.tile_bits;
    p.low_bits = p.tile_bits > 8 ? LOW_BITS : 0;
    p.high_bits = p.tile_bits - p.low_bits;
    long long g = div_up(n, STAGE);
    p.grid1 = (int)(g < 1 ? 1 : g > MAX_BLOCKS ? MAX_BLOCKS : g);
    const long long nseg = 1LL << p.high_bits;
    long long k = div_up(n, nseg * STAGE);
    const long long kmax = div_up(MAX_BLOCKS, nseg);
    p.per_seg2 = (int)(k < 1 ? 1 : k > kmax ? kmax : k);
    p.grid2 = p.low_bits ? (int)(nseg * p.per_seg2) : 0;
    const long long h1 = (long long)p.grid1 << p.high_bits;
    const long long h2 = (long long)p.grid2 << p.low_bits;
    p.hist_words = h1 > h2 ? h1 : h2;
    return p;
}

}  // namespace

BtlTileScratch btl_tile_scratch(uint32_t* scratch, long long n,
                                long long nwords) {
    const Plan p = plan(n, nwords);
    const long long at_pos = p.padded + 1;
    const long long at_off1 = at_pos + n;
    const long long at_stage = at_off1 + (1LL << p.high_bits) + 1;
    const long long at_hist = at_stage + (p.low_bits ? n : 0);
    BtlTileScratch s{};
    s.words = at_hist + p.hist_words;
    if (scratch) {
        s.offsets = scratch;
        s.pos = scratch + at_pos;
        s.offsets1 = scratch + at_off1;
        s.stage = scratch + at_stage;
        s.hist = scratch + at_hist;
    }
    return s;
}

cudaError_t btl_tile_partition_run(const uint32_t* pos, long long n,
                                   long long nwords, int word_shift,
                                   uint32_t* scratch, cudaStream_t stream) {
    const long long ntiles = btl_ntiles(nwords);
    if (ntiles < 1 || ntiles > BTL_MAX_TILES || n < 0 || n >= (1LL << 31))
        return cudaErrorInvalidValue;
    const Plan p = plan(n, nwords);
    const BtlTileScratch s = btl_tile_scratch(scratch, n, nwords);
    cudaError_t err = cudaMemsetAsync(s.offsets, 0,
                                      (p.padded + 1) * sizeof(uint32_t),
                                      stream);
    if (err == cudaSuccess && p.low_bits)
        err = cudaMemsetAsync(s.offsets1, 0,
                              ((1LL << p.high_bits) + 1) * sizeof(uint32_t),
                              stream);
    if (err != cudaSuccess || n == 0) return err;
    // pass 1: the high bits (all of them for a one-pass partition)
    Pass P{pos, nullptr, n, p.grid1, nwords, 1, word_shift, p.low_bits,
           1 << p.high_bits, p.low_bits ? s.offsets1 : s.offsets, s.hist,
           p.low_bits ? s.stage : s.pos};
    tp_count<<<p.grid1, THREADS, 0, stream>>>(P);
    tp_scan<<<1, 1024, 0, stream>>>(P.counts, P.buckets);
    tp_scatter<<<p.grid1, THREADS, 0, stream>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess || !p.low_bits) return err;
    // pass 2: the low bits inside each high bucket; bucket index
    // seg * 2**low_bits + digit is the tile
    Pass Q{s.stage, s.offsets1, n, p.per_seg2, nwords, 0, word_shift, 0,
           1 << p.low_bits, s.offsets, s.hist, s.pos};
    tp_count<<<p.grid2, THREADS, 0, stream>>>(Q);
    tp_scan<<<1, 1024, 0, stream>>>(Q.counts, (int)p.padded);
    tp_scatter<<<p.grid2, THREADS, 0, stream>>>(Q);
    return cudaGetLastError();
}

// The partition alone: pos uint32 [n], scratch of
// btl_tile_partition_scratch(n, nwords) words.
extern "C" int btl_tile_partition(const void* pos, long long n,
                                  long long nwords, int word_shift,
                                  void* scratch, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    return (int)btl_tile_partition_run((const uint32_t*)pos, n, nwords,
                                       word_shift, (uint32_t*)scratch,
                                       (cudaStream_t)stream);
}

// uint32 words of scratch a partition of n positions into the tiles of an
// array of nwords words takes.
extern "C" long long btl_tile_partition_scratch(long long n,
                                                long long nwords) {
    return btl_tile_scratch(nullptr, n, nwords).words;
}
