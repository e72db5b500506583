// MIBF rank lookup: for every bit position p of the frozen bit vector,
//   rank = cum_ranks[p >> 5] + popc(bv[p >> 5] & ((1 << (p & 31)) - 1))
//   hit  = (bv[p >> 5] >> (p & 31)) & 1
// and, in rank + ID mode, raw = hit ? data[min(rank, d_size - 1)] : 0 from
// the ID plane (uint8, uint16, uint32 or uint64 elements, saturation and
// strand bits kept; raw is uint32, or uint64 for the uint64 plane).
//
// Replaces: btl_bloomfilter_tpu/kernels/gather_words.py:_kernel2 (behind
// gather_words_pair_sorted, the bv word and its cumulative rank in one
// windowed pass) and the same file's _kernel in the MIBF ID-plane mode
// (gather_words_sorted at shift 5 over the bitcast ID plane), with the whole
// chain around them in models/mibf.py rank_of_positions_kernel and
// rank_data_of_positions_kernel: the position sort, the popcount, the packed
// (rank << 1 | hit) un-sort and the window-overflow fallback. The TPU needs
// sorted positions to stream windows through VMEM; on Hopper each position
// loads what it needs directly, so no sort is needed and the chain is one
// pass.
//
// Layout: the rank directory (kernels/mibf_rank.py rank_directory, built
// once by models/mibf.py freeze): one 32-byte block a 7 words of the bit
// vector, the block's cumulative count (cum_ranks of its first word) and
// then its 7 words (zero past the vector). Word w lies in block w / 7 at
// slot w % 7; its rank is the block's count plus the popcounts of the
// block's words before it. The directory is 8/7 of the bit vector.
//
// What bounds it on the H100: random sector loads. bv_words and cum_ranks
// are two arrays, so a lookup through them reads two random 32-byte
// sectors; through the directory it reads one, and at bench.py's 2**28
// bits the directory (38 MB) fits the 50 MB L2 where the two arrays (64
// MB) did not. On a hit the ID is one more random load (8 bytes at width 8,
// still inside one sector; the JAX package gathers the two uint32 planes of
// a width-8 filter with XLA, mibf.py:288-296). Design: one thread
// a position in a grid-stride loop, the block read as two 16-byte loads of
// one sector; coalesced position loads and output stores; the ID load is
// skipped on a miss, where raw is 0 anyway. Position words past the vector
// are clamped to its last word, as an XLA gather clamps.

#include "common.cuh"

// T: the ID plane's element, R: raw's (uint32_t, or unsigned long long
// for the uint64 plane)
template <typename T, typename R>
__global__ void __launch_bounds__(BTL_BLOCK)
mibf_rank_kernel(const uint32_t* __restrict__ pos, long long n,
                 const uint4* __restrict__ dir, uint32_t nwords,
                 const T* __restrict__ data, long long d_size,
                 int32_t* __restrict__ rank, bool* __restrict__ hit,
                 R* __restrict__ raw) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const uint32_t p = pos[i];
        const uint32_t w = min(p >> 5, nwords - 1u);
        const uint32_t b = w / 7u, j = w - 7u * b;
        const uint4 lo = __ldg(&dir[2 * (size_t)b]);
        const uint4 hi = __ldg(&dir[2 * (size_t)b + 1]);
        const uint32_t v[7] = {lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t r = lo.x, word = 0;
#pragma unroll
        for (uint32_t k = 0; k < 7; ++k) {
            if (k < j) r += __popc(v[k]);
            if (k == j) word = v[k];
        }
        const uint32_t bit = p & 31u;
        r += __popc(word & ((1u << bit) - 1u));
        const bool h = (word >> bit) & 1u;
        rank[i] = (int32_t)r;
        hit[i] = h;
        if (raw != nullptr) {
            R x = 0;
            if (h) {
                const long long rc = (long long)r < d_size ? (long long)r
                                                           : d_size - 1;
                x = (R)__ldg(&data[rc]);
            }
            raw[i] = x;
        }
    }
}

template <typename T, typename R = uint32_t>
static cudaError_t launch(const void* pos, long long n, const void* dir,
                          long long nwords, const void* data,
                          long long d_size, void* rank, void* hit, void* raw,
                          cudaStream_t stream) {
    mibf_rank_kernel<T, R><<<btl_blocks(n), BTL_BLOCK, 0, stream>>>(
        (const uint32_t*)pos, n, (const uint4*)dir, (uint32_t)nwords,
        (const T*)data, d_size, (int32_t*)rank, (bool*)hit, (R*)raw);
    return cudaGetLastError();
}

// pos uint32 [n]; dir the rank directory of a bit vector of nwords words
// (1 <= nwords <= 2**27), 16-byte aligned; data [d_size] of `width` bytes
// (1, 2, 4 or 8), or null with width 0 for rank-only mode (raw then null
// too); rank int32 [n], hit bool [n], raw uint32 [n] (uint64 at width 8).
extern "C" int btl_mibf_rank(const void* pos, long long n, const void* dir,
                             long long nwords, const void* data, int width,
                             long long d_size, void* rank, void* hit,
                             void* raw, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nwords < 1 || nwords > (1LL << 27) ||
        (reinterpret_cast<uintptr_t>(dir) & 15))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (width) {
        case 0:
            return (int)launch<uint32_t>(pos, n, dir, nwords, nullptr, 0,
                                         rank, hit, nullptr, s);
        case 1:
            return (int)launch<uint8_t>(pos, n, dir, nwords, data, d_size,
                                        rank, hit, raw, s);
        case 2:
            return (int)launch<uint16_t>(pos, n, dir, nwords, data, d_size,
                                         rank, hit, raw, s);
        case 4:
            return (int)launch<uint32_t>(pos, n, dir, nwords, data, d_size,
                                         rank, hit, raw, s);
        case 8:
            return (int)launch<unsigned long long, unsigned long long>(
                pos, n, dir, nwords, data, d_size, rank, hit, raw, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
