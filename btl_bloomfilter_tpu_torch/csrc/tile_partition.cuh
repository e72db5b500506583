// The tile partition shared by the tiled scatters (scatter_or.cu,
// scatter_add.cu): positions grouped by the tile of the array they write.
#pragma once

#include "common.cuh"

// Words of a tile of the tiled scatters: 2**14 words = 64 KiB. A block
// holds one tile in shared memory, so a tile must fit the 227 KB a block
// can have; at 64 KiB three blocks share an SM and one block's load
// overlaps another's apply. A 2**30-counter u8 filter (2**28 words) has
// 16384 tiles. kernels/tile_partition.py reads this line and the next
// define, so each stays a plain number.
#define BTL_TILE_SHIFT 14

// Most tiles a partition takes, 2**15: two passes of at most 8 and 7 bits
// of the tile index (tile_partition.cu), and a histogram of every tile in
// 128 KiB of shared memory.
#define BTL_MAX_TILES 32768

// Group the live positions of pos uint32 [n] by tile (p >> word_shift) >>
// BTL_TILE_SHIFT, dropping the sentinel and positions whose word is past
// nwords. scratch holds btl_tile_partition_scratch(n, nwords) words, laid
// out as btl_tile_scratch says. Launches every stage on stream and returns
// the first launch error.
cudaError_t btl_tile_partition_run(const uint32_t* pos, long long n,
                                   long long nwords, int word_shift,
                                   uint32_t* scratch, cudaStream_t stream);

// The same for wide positions: pos int64 [n] with -1 as the sentinel
// (Bloom filters from 2**32 bits). The grouped positions hold each
// position's low 32 bits; the tile gives the rest. Requires word_shift +
// BTL_TILE_SHIFT + 7 <= 32.
cudaError_t btl_tile_partition_run_wide(const long long* pos, long long n,
                                        long long nwords, int word_shift,
                                        uint32_t* scratch,
                                        cudaStream_t stream);

// The tiles of an array of nwords words.
static inline long long btl_ntiles(long long nwords) {
    return (nwords + (1LL << BTL_TILE_SHIFT) - 1) >> BTL_TILE_SHIFT;
}

// A partition's scratch. In order: offsets [P + 1] (P the tile count
// rounded up to a power of two; offsets[t] is where tile t's positions
// start, offsets[ntiles] the number of live positions), the grouped
// positions [n], then the partition's own: the tile counts that become
// each tile's next free slot [P], the histogram's ticket [1], and for a
// two-pass partition the first pass's next free slot of each high bucket
// [H], the second pass's first chunk of each bucket [H + 1] and the first
// pass's output [n]. words is the total; with scratch null only words is
// set.
struct BtlTileScratch {
    uint32_t* offsets;
    uint32_t* pos;
    uint32_t* cursor;
    uint32_t* cursor1;
    uint32_t* chunks;
    uint32_t* stage;
    long long words;
};

BtlTileScratch btl_tile_scratch(uint32_t* scratch, long long n,
                                long long nwords);

// Words of a tile (BTL_TILE_SHIFT), and the threads of a block that sweeps
// one.
#define BTL_TILE_WORDS (1 << BTL_TILE_SHIFT)
#define BTL_TILE_THREADS 512

// Words a sweep thread moves per step: 8 loads of 16 bytes in flight.
#define BTL_TILE_UNROLL 8

// Copy the len words of a tile between global memory g and shared memory s
// (kLoad: g -> s, else s -> g), 16 bytes a load where g is 16-byte aligned
// (a tile starts at a multiple of 2**BTL_TILE_SHIFT words, so it is when
// the array is), 8 of them in flight a thread.
template <bool kLoad>
__device__ __forceinline__ void btl_tile_copy(uint32_t* s, uint32_t* g,
                                              int len) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        uint4* s4 = reinterpret_cast<uint4*>(s);
        uint4* g4 = reinterpret_cast<uint4*>(g);
        const int nv = len >> 2;
        for (int i0 = threadIdx.x; i0 < nv;
             i0 += BTL_TILE_UNROLL * blockDim.x) {
            uint4 r[BTL_TILE_UNROLL];
#pragma unroll
            for (int j = 0; j < BTL_TILE_UNROLL; ++j) {
                const int i = i0 + j * blockDim.x;
                if (i < nv) r[j] = kLoad ? g4[i] : s4[i];
            }
#pragma unroll
            for (int j = 0; j < BTL_TILE_UNROLL; ++j) {
                const int i = i0 + j * blockDim.x;
                if (i < nv) {
                    if (kLoad) s4[i] = r[j];
                    else g4[i] = r[j];
                }
            }
        }
        done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += blockDim.x) {
        if (kLoad) s[i] = g[i];
        else g[i] = s[i];
    }
}

// Raise a kernel's dynamic shared memory limit to bytes (above 48 KiB it
// must be asked for), once a device; *done holds a bit a device.
template <typename K>
static inline cudaError_t btl_allow_smem(K kernel, int bytes, int device,
                                         unsigned long long* done) {
    const unsigned long long bit = 1ULL << (device & 63);
    if (*done & bit) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) *done |= bit;
    return err;
}

// The sparse route of incrementAll (scatter_add.cu), for arrays past
// BTL_MAX_TILES tiles. The partition above runs unchanged on
// coarse tiles of 2**(BTL_TILE_SHIFT + extra) words: it is called with
// word_shift + extra and the coarse word count btl_coarse_words(nwords,
// extra), extra the least that brings the coarse tiles down to
// BTL_MAX_TILES (kernels/tile_partition.py coarse_shift). A coarse word
// holds 2**extra words, so positions of the last coarse word that lie past
// the array pass the partition; the apply drops them. Then one block a
// coarse tile sorts the tile's positions in shared memory,
// BTL_SPARSE_KEYS at a time, and updates each distinct word once, in
// address order: no tile-sized buffer, whatever the tile's size.
#define BTL_SPARSE_THREADS 256
#define BTL_SPARSE_KEYS 2048

static inline long long btl_coarse_words(long long nwords, int extra) {
    return (nwords + (1LL << extra) - 1) >> extra;
}

// Load chunk [c, c + n) of a coarse tile's grouped positions into s as
// keys, each position's bits below key_bits (its place in the tile; a
// coarse tile spans a power of two positions that divides 2**32), padded
// with 0xFFFFFFFF to m, the least power of two >= n; then sort s[0, m)
// ascending with a bitonic network, one barrier a stage. Every thread of
// the block calls it; s is sorted and visible to all when it returns.
__device__ __forceinline__ void btl_sparse_sort(const uint32_t* grouped,
                                                uint32_t c, int n,
                                                int key_bits, uint32_t* s) {
    const uint32_t key_mask =
        key_bits >= 32 ? 0xFFFFFFFFu : (1u << key_bits) - 1u;
    int m = 1;
    while (m < n) m <<= 1;
    for (int i = threadIdx.x; i < m; i += blockDim.x)
        s[i] = i < n ? (grouped[c + i] & key_mask) : 0xFFFFFFFFu;
    __syncthreads();
    for (int k = 2; k <= m; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < (m >> 1); i += blockDim.x) {
                const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
                const uint32_t x = s[a], y = s[a + j];
                if ((x > y) == ((a & k) == 0)) {
                    s[a] = y;
                    s[a + j] = x;
                }
            }
            __syncthreads();
        }
    }
}

// The end of the run of keys equal to s[j] in the sorted s[0, n): one
// look for a run of one, a binary search for a longer run.
__device__ __forceinline__ int btl_run_end(const uint32_t* s, int j, int n) {
    const uint32_t key = s[j];
    if (j + 1 >= n || s[j + 1] != key) return j + 1;
    int lo = j + 1, hi = n;      // s[lo] == key; hi == n or s[hi] > key
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s[mid] == key) lo = mid;
        else hi = mid;
    }
    return hi;
}
