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
// What bounds it on the H100: the bytes it streams and the operations
// that wait on each other. A one-pass counting sort into thousands of
// tiles does not stream: each chunk's run in each tile is a few positions
// long, so the writes scatter into millions of partly written sectors
// (PERF.md: one pass into the 2048 tiles of a 2**30-bit filter took 0.054
// ms on the card, two took 0.033). Design, a most-significant-digit
// counting sort in at most four operations on the stream (the parent
// design took eight: a count, a one-block scan and a scatter a pass, and
// two memsets):
//   * the histogram (tp_hist): one read of the positions counts every
//     tile at once in shared memory (at most 32768 counters, 132 KiB with
//     the padding that keeps a thread's run of them off its neighbours'
//     banks), one global add per block and tile; the last block to finish
//     (a ticket) scans the counts into the offsets, which also give the
//     high buckets' offsets for the second pass. No count pass and no scan
//     launch of its own;
//   * one scatter pass (tp_scatter) on the whole tile index where the
//     tiles are at most 256 (ONE_PASS_BITS), else two: the tile index's
//     high bits, then its low 7 bits inside each high bucket. A block
//     ranks a chunk of 8192 positions at a time in shared memory, stages
//     them there grouped by bucket, takes each bucket's slots with one
//     global atomicAdd on the bucket's next free slot (the order inside a
//     bucket is free, so there is no look-back and nothing serialises on
//     skewed input: every position in one tile costs one atomic a chunk),
//     and writes each bucket's run with consecutive threads on consecutive
//     addresses, the next chunk loading meanwhile. Runs average 64
//     positions or more. The second pass's chunks never straddle a high
//     bucket, so its buckets are the 128 low digits, and a bucket of any
//     size spreads over every block.
// The positions stream five times (three for one pass), against six. The
// sentinel and positions past the array are dropped by the histogram and
// the first pass.
//
// Wide positions (int64, sentinel -1; Bloom filters from 2**32 bits) take
// template instantiations of the histogram and the first pass of their own:
// they read int64 and stage it in shared memory as such, but write each
// position's low 32 bits. A tile spans 2**(BTL_TILE_SHIFT + word_shift)
// positions, a divisor of 2**32, so the low bits and the tile give the
// position back; the second pass reads the low bits and takes its bucket,
// the tile index's low bits, from them (kLow). The grouped positions, the
// scratch and the offsets keep the narrow layout.

#include "tile_partition.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// positions a scatter block ranks and stages at a time, and its log
constexpr int RANK_BITS = 13;
constexpr int STAGE = 1 << RANK_BITS;
constexpr int ITEMS = STAGE / THREADS;
// at most 2**ONE_PASS_BITS tiles: one scatter pass
constexpr int ONE_PASS_BITS = 8;
// low bits of the tile index sorted by the second pass
constexpr int LOW_BITS = 7;
static_assert((1 << ONE_PASS_BITS) <= THREADS && (1 << LOW_BITS) <= THREADS,
              "a scatter thread scans one bucket");
constexpr int HIST_THREADS = 1024;
constexpr int HIST_ITEMS = 16;
// positions of type In a histogram thread loads at a time: the same bytes
// (HIST_ITEMS narrow ones), so wide ones fit the registers too
template <typename In>
constexpr int HIST_ITEMS_OF =
    HIST_ITEMS * (int)sizeof(uint32_t) / (int)sizeof(In);
constexpr int SMS = 132;                 // an H100's SMs
// blocks of the histogram and of a scatter pass: two an SM
constexpr int HIST_BLOCKS = 2 * SMS;
constexpr int SCATTER_BLOCKS = 2 * SMS;
constexpr uint32_t DROP = 0xFFFFFFFFu;   // a rank code of no position

// The tile of position p, or -1 where it is dropped.
__device__ __forceinline__ int tile_of(uint32_t p, long long nwords,
                                       int word_shift) {
    const uint32_t w = p >> word_shift;
    if (p == BTL_SENTINEL || (long long)w >= nwords) return -1;
    return (int)(w >> BTL_TILE_SHIFT);
}

// The same for a wide position (negative: the sentinel).
__device__ __forceinline__ int tile_of(unsigned long long p,
                                       long long nwords, int word_shift) {
    const long long w = (long long)p >> word_shift;
    if ((long long)p < 0 || w >= nwords) return -1;
    return (int)(w >> BTL_TILE_SHIFT);
}

// A histogram's slot of tile t: one word of padding every 32, so that a
// thread's run of consecutive tiles in the scan meets no other thread of
// its warp in a bank.
__device__ __forceinline__ int slot(int t) { return t + (t >> 5); }

// Exclusive scan of one value a thread over a block of NT threads; *total
// is the sum. Every thread calls it.
template <int NT>
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* s_warp,
                                               uint32_t* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += u;
    }
    __syncthreads();            // s_warp's last readers are done
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        uint32_t x = lane < NT / 32 ? s_warp[lane] : 0u;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t u = __shfl_up_sync(0xFFFFFFFFu, x, d);
            if (lane >= d) x += u;
        }
        if (lane < NT / 32) s_warp[lane] = x;
    }
    __syncthreads();
    *total = s_warp[NT / 32 - 1];
    return (warp ? s_warp[warp - 1] : 0u) + incl - v;
}

// Counts every tile of pos into counts [padded] (zeroed, with the ticket
// at counts[padded]); the last block turns them into offsets [padded + 1]
// and leaves each tile's first slot in counts. With low_bits: cursor1 [H]
// the first slot of each high bucket, chunks [H + 1] the second pass's
// first chunk of each high bucket (H = padded >> low_bits).
template <typename In>
__global__ void __launch_bounds__(HIST_THREADS, 2)
tp_hist(const In* __restrict__ pos, long long n, long long nwords,
        int word_shift, int padded, int low_bits, uint32_t* counts,
        uint32_t* offsets, uint32_t* cursor1, uint32_t* chunks) {
    extern __shared__ uint32_t s_hist[];
    __shared__ uint32_t s_warp[32];
    __shared__ bool s_last;
    for (int t = threadIdx.x; t < slot(padded); t += HIST_THREADS)
        s_hist[t] = 0;
    __syncthreads();
    const long long stride = (long long)gridDim.x * HIST_THREADS;
    for (long long i0 = (long long)blockIdx.x * HIST_THREADS + threadIdx.x;
         i0 < n; i0 += HIST_ITEMS_OF<In> * stride) {
        In p[HIST_ITEMS_OF<In>];
#pragma unroll
        for (int j = 0; j < HIST_ITEMS_OF<In>; ++j) {
            const long long i = i0 + j * stride;
            p[j] = i < n ? pos[i] : ~(In)0;
        }
#pragma unroll
        for (int j = 0; j < HIST_ITEMS_OF<In>; ++j) {
            const int t = tile_of(p[j], nwords, word_shift);
            if (t >= 0) atomicAdd(&s_hist[slot(t)], 1u);
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < padded; t += HIST_THREADS) {
        const uint32_t c = s_hist[slot(t)];
        if (c) atomicAdd(&counts[t], c);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(&counts[padded], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    // the last block: every other block's adds are in L2
    __threadfence();
    for (int t = threadIdx.x; t < padded; t += HIST_THREADS)
        s_hist[slot(t)] = __ldcg(&counts[t]);
    __syncthreads();
    const int per = (padded + HIST_THREADS - 1) / HIST_THREADS;
    const int first = threadIdx.x * per;
    uint32_t sum = 0;
    for (int j = 0; j < per && first + j < padded; ++j)
        sum += s_hist[slot(first + j)];
    uint32_t live;
    uint32_t run = block_scan<HIST_THREADS>(sum, s_warp, &live);
    for (int j = 0; j < per && first + j < padded; ++j) {
        const uint32_t c = s_hist[slot(first + j)];
        s_hist[slot(first + j)] = run;
        run += c;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < padded; t += HIST_THREADS) {
        offsets[t] = s_hist[slot(t)];
        counts[t] = s_hist[slot(t)];
    }
    if (threadIdx.x == 0) offsets[padded] = live;
    if (!low_bits) return;
    const int H = padded >> low_bits;
    uint32_t nch = 0;
    if ((int)threadIdx.x < H) {
        const uint32_t lo = s_hist[slot(threadIdx.x << low_bits)];
        const uint32_t hi = (int)threadIdx.x + 1 < H
                                ? s_hist[slot((threadIdx.x + 1) << low_bits)]
                                : live;
        cursor1[threadIdx.x] = lo;
        nch = (hi - lo + STAGE - 1) / STAGE;
    }
    uint32_t all;
    const uint32_t c0 = block_scan<HIST_THREADS>(nch, s_warp, &all);
    if ((int)threadIdx.x < H) chunks[threadIdx.x] = c0;
    if (threadIdx.x == 0) chunks[H] = all;
}

template <typename In>
struct Pass {
    const In* in;             // positions in
    uint32_t* out;            // positions out
    long long n;              // positions in, for a pass without chunks
    long long nwords;
    int word_shift;
    int filter;               // drop the sentinel and past-array positions
    int shift;                // a position's bucket: (tile >> shift) - base
    int buckets;              // B, a power of two <= 2**ONE_PASS_BITS
    uint32_t* cursor;         // next free slot of bucket base + d
    // the second pass: high bucket s holds chunks chunks[s] to chunks[s +
    // 1] - 1 and spans offsets[s << seg_shift] to offsets[(s + 1) <<
    // seg_shift]; its base is s << seg_shift. Null: chunks of STAGE
    // positions from 0 to n, base 0.
    const uint32_t* chunks;
    const uint32_t* offsets;
    int nseg;
    int seg_shift;
};

// Chunk c's positions [lo, hi) and bucket base.
template <typename In>
__device__ __forceinline__ void chunk_range(const Pass<In>& P,
                                            const uint32_t* s_chunks,
                                            uint32_t c, long long* lo,
                                            long long* hi, uint32_t* base) {
    if (!P.chunks) {
        *lo = (long long)c * STAGE;
        *hi = *lo + STAGE < P.n ? *lo + STAGE : P.n;
        *base = 0;
        return;
    }
    int a = 0, b = P.nseg;      // the last s with s_chunks[s] <= c
    while (b - a > 1) {
        const int m = (a + b) >> 1;
        if (s_chunks[m] <= c) a = m;
        else b = m;
    }
    *lo = P.offsets[a << P.seg_shift] + (long long)(c - s_chunks[a]) * STAGE;
    const long long end = P.offsets[(a + 1) << P.seg_shift];
    *hi = *lo + STAGE < end ? *lo + STAGE : end;
    *base = (uint32_t)a << P.seg_shift;
}

template <typename In>
__device__ __forceinline__ void load_chunk(const Pass<In>& P, long long lo,
                                           long long hi, In* p) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        const long long i = lo + threadIdx.x + (long long)j * THREADS;
        p[j] = i < hi ? P.in[i] : ~(In)0;
    }
}

// The bucket of a live position. kLow: p is a wide position's low 32
// bits, which hold the tile index's low bits; the buckets of the second
// pass are those bits.
template <bool kLow, typename In>
__device__ __forceinline__ int bucket(const Pass<In>& P, In p,
                                      uint32_t base) {
    const int d = (int)((((p >> P.word_shift) >> BTL_TILE_SHIFT) >> P.shift)
                        - base);
    return kLow ? d & (P.buckets - 1) : d;
}

// In: the positions' type, uint32_t or (wide) unsigned long long; the
// stage holds In, the output their low 32 bits.
template <typename In, bool kLow>
__global__ void __launch_bounds__(THREADS, SCATTER_BLOCKS / SMS)
tp_scatter(Pass<In> P) {
    extern __shared__ __align__(16) uint32_t smem[];
    const int B = P.buckets;
    In* s_keys = reinterpret_cast<In*>(smem);                 // [STAGE]
    // [B] this chunk's, a bucket
    uint32_t* s_count = smem + STAGE * (sizeof(In) / sizeof(uint32_t));
    uint32_t* s_start = s_count + B;         // [B] their exclusive scan
    uint32_t* s_delta = s_start + B;         // [B] out slot - staged slot
    uint32_t* s_chunks = s_delta + B;        // [nseg + 1]
    __shared__ uint32_t s_warp[WARPS];
    if (P.chunks)
        for (int s = threadIdx.x; s <= P.nseg; s += THREADS)
            s_chunks[s] = P.chunks[s];
    if ((int)threadIdx.x < B) s_count[threadIdx.x] = 0;
    __syncthreads();
    const uint32_t total = P.chunks
                               ? s_chunks[P.nseg]
                               : (uint32_t)((P.n + STAGE - 1) / STAGE);
    uint32_t c = blockIdx.x, base = 0;
    long long lo = 0, hi = 0;
    In p[ITEMS];
    if (c < total) {
        chunk_range(P, s_chunks, c, &lo, &hi, &base);
        load_chunk(P, lo, hi, p);
    }
    for (; c < total; c += gridDim.x) {
        // rank each position inside its bucket
        uint32_t code[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const long long i = lo + threadIdx.x + (long long)j * THREADS;
            bool live = i < hi;
            if (live && P.filter)
                live = tile_of(p[j], P.nwords, P.word_shift) >= 0;
            code[j] = DROP;
            if (live) {
                const int d = bucket<kLow>(P, p[j], base);
                code[j] = ((uint32_t)d << RANK_BITS) |
                          atomicAdd(&s_count[d], 1u);
            }
        }
        __syncthreads();
        // the buckets' starts in the stage and their slots in out, a
        // bucket a thread
        const int d = threadIdx.x;
        const uint32_t cnt = d < B ? s_count[d] : 0u;
        uint32_t live;
        const uint32_t start = block_scan<THREADS>(cnt, s_warp, &live);
        if (d < B) {
            s_start[d] = start;
            if (cnt) s_delta[d] = atomicAdd(&P.cursor[base + d], cnt) - start;
            s_count[d] = 0;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            if (code[j] != DROP)
                s_keys[s_start[code[j] >> RANK_BITS] +
                       (code[j] & (STAGE - 1))] = p[j];
        // the next chunk's loads fly while this one is written out
        const uint32_t base_now = base;
        if (c + gridDim.x < total) {
            chunk_range(P, s_chunks, c + gridDim.x, &lo, &hi, &base);
            load_chunk(P, lo, hi, p);
        }
        __syncthreads();
        // each bucket's run, consecutive threads on consecutive addresses
        for (uint32_t i = threadIdx.x; i < live; i += THREADS) {
            const In key = s_keys[i];
            P.out[s_delta[bucket<kLow>(P, key, base_now)] + i] =
                (uint32_t)key;
        }
        __syncthreads();
    }
}

int ceil_log2(long long x) {
    int b = 0;
    while ((1LL << b) < x) ++b;
    return b;
}

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

struct Plan {
    int tile_bits, high_bits, low_bits;   // low_bits 0: one pass
    int padded;                           // 2**tile_bits tiles
    int nseg;                             // 2**high_bits
};

Plan plan(long long nwords) {
    Plan p;
    p.tile_bits = ceil_log2(btl_ntiles(nwords));
    p.padded = 1 << p.tile_bits;
    p.low_bits = p.tile_bits > ONE_PASS_BITS ? LOW_BITS : 0;
    p.high_bits = p.tile_bits - p.low_bits;
    p.nseg = 1 << p.high_bits;
    return p;
}

constexpr int HIST_SMEM =
    (BTL_MAX_TILES + (BTL_MAX_TILES >> 5)) * (int)sizeof(uint32_t);

// The partition of positions of type In (see btl_tile_partition_run).
template <typename In>
cudaError_t partition_run(const In* pos, long long n, long long nwords,
                          int word_shift, uint32_t* scratch,
                          cudaStream_t stream) {
    const long long ntiles = btl_ntiles(nwords);
    if (ntiles < 1 || ntiles > BTL_MAX_TILES || n < 0 || n >= (1LL << 31))
        return cudaErrorInvalidValue;
    const Plan p = plan(nwords);
    const BtlTileScratch s = btl_tile_scratch(scratch, n, nwords);
    if (n == 0)
        return cudaMemsetAsync(s.offsets, 0,
                               (p.padded + 1) * sizeof(uint32_t), stream);
    static unsigned long long hist_set = 0, scatter_set = 0;
    constexpr int WORD = (int)sizeof(uint32_t);
    const int B1 = p.nseg;
    const int smem1 = STAGE * (int)sizeof(In) + 3 * B1 * WORD;
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = btl_allow_smem(tp_hist<In>, HIST_SMEM, device, &hist_set);
    // a wide stage takes more than the 48 KiB a block has unasked: allow
    // the most any plan asks, at 2**ONE_PASS_BITS buckets
    if (err == cudaSuccess && sizeof(In) > sizeof(uint32_t))
        err = btl_allow_smem(tp_scatter<In, false>,
                             STAGE * (int)sizeof(In) +
                                 3 * (1 << ONE_PASS_BITS) * WORD,
                             device, &scatter_set);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(s.cursor, 0, (p.padded + 1) * sizeof(uint32_t),
                              stream);
    if (err != cudaSuccess) return err;
    const long long hist_grid =
        div_up(n, (long long)HIST_THREADS * HIST_ITEMS_OF<In>);
    tp_hist<In><<<(unsigned)(hist_grid < HIST_BLOCKS ? hist_grid
                                                     : HIST_BLOCKS),
                  HIST_THREADS,
                  (p.padded + (p.padded >> 5)) * sizeof(uint32_t), stream>>>(
        pos, n, nwords, word_shift, p.padded, p.low_bits, s.cursor,
        s.offsets, s.cursor1, s.chunks);
    const long long nchunks = div_up(n, STAGE);
    const int grid1 =
        (int)(nchunks < SCATTER_BLOCKS ? nchunks : SCATTER_BLOCKS);
    // the first pass: the high bits (all of them for a one-pass partition)
    Pass<In> P{pos, p.low_bits ? s.stage : s.pos, n, nwords, word_shift, 1,
               p.low_bits, B1, p.low_bits ? s.cursor1 : s.cursor, nullptr,
               nullptr, 0, 0};
    tp_scatter<In, false><<<grid1, THREADS, smem1, stream>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess || !p.low_bits) return err;
    // the second pass: the low bits inside each high bucket, in chunks
    // that never straddle one
    const long long nchunks2 = nchunks + p.nseg;
    const int B2 = 1 << p.low_bits;
    Pass<uint32_t> Q{s.stage, s.pos, n, nwords, word_shift, 0, 0, B2,
                     s.cursor, s.chunks, s.offsets, p.nseg, p.low_bits};
    constexpr bool kLow = sizeof(In) > sizeof(uint32_t);
    tp_scatter<uint32_t, kLow><<<(int)(nchunks2 < SCATTER_BLOCKS
                                           ? nchunks2
                                           : SCATTER_BLOCKS),
                                 THREADS,
                                 (STAGE + 3 * B2 + p.nseg + 1) *
                                     sizeof(uint32_t),
                                 stream>>>(Q);
    return cudaGetLastError();
}

}  // namespace

BtlTileScratch btl_tile_scratch(uint32_t* scratch, long long n,
                                long long nwords) {
    const Plan p = plan(nwords);
    const long long two = p.low_bits ? 1 : 0;
    const long long at_pos = p.padded + 1;
    const long long at_cursor = at_pos + n;
    const long long at_cursor1 = at_cursor + p.padded + 1;
    const long long at_chunks = at_cursor1 + two * p.nseg;
    const long long at_stage = at_chunks + two * (p.nseg + 1);
    BtlTileScratch s{};
    s.words = at_stage + two * n;
    if (scratch) {
        s.offsets = scratch;
        s.pos = scratch + at_pos;
        s.cursor = scratch + at_cursor;
        s.cursor1 = scratch + at_cursor1;
        s.chunks = scratch + at_chunks;
        s.stage = scratch + at_stage;
    }
    return s;
}

cudaError_t btl_tile_partition_run(const uint32_t* pos, long long n,
                                   long long nwords, int word_shift,
                                   uint32_t* scratch, cudaStream_t stream) {
    return partition_run(pos, n, nwords, word_shift, scratch, stream);
}

cudaError_t btl_tile_partition_run_wide(const long long* pos, long long n,
                                        long long nwords, int word_shift,
                                        uint32_t* scratch,
                                        cudaStream_t stream) {
    // the second pass takes LOW_BITS of the tile index from the low bits
    if (word_shift + BTL_TILE_SHIFT + LOW_BITS > 32)
        return cudaErrorInvalidValue;
    return partition_run((const unsigned long long*)pos, n, nwords,
                         word_shift, scratch, stream);
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

// The same for wide positions: pos int64 [n], -1 the sentinel; grouped
// holds each position's low 32 bits.
extern "C" int btl_tile_partition_wide(const void* pos, long long n,
                                       long long nwords, int word_shift,
                                       void* scratch, int device,
                                       void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    return (int)btl_tile_partition_run_wide(
        (const long long*)pos, n, nwords, word_shift, (uint32_t*)scratch,
        (cudaStream_t)stream);
}

// uint32 words of scratch a partition of n positions into the tiles of an
// array of nwords words takes.
extern "C" long long btl_tile_partition_scratch(long long n,
                                                long long nwords) {
    return btl_tile_scratch(nullptr, n, nwords).words;
}
