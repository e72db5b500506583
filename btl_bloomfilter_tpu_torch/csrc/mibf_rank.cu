// MIBF rank lookup: for every bit position p of the frozen bit vector,
//   rank = cum_ranks[p >> 5] + popc(bv[p >> 5] & ((1 << (p & 31)) - 1))
//   hit  = (bv[p >> 5] >> (p & 31)) & 1
// and, in rank + ID mode, raw = hit ? data[min(rank, d_size - 1)] : 0 from
// the ID plane (uint8, uint16 or uint32 elements, saturation and strand
// bits kept).
//
// Replaces: btl_bloomfilter_tpu/kernels/gather_words.py:_kernel2 (behind
// gather_words_pair_sorted, the bv word and its cumulative rank in one
// windowed pass) and the same file's _kernel in the MIBF ID-plane mode
// (gather_words_sorted at shift 5 over the bitcast ID plane), with the whole
// chain around them in models/mibf.py rank_of_positions_kernel and
// rank_data_of_positions_kernel: the position sort, the popcount, the packed
// (rank << 1 | hit) un-sort and the window-overflow fallback. The TPU needs
// sorted positions to stream windows through VMEM; on Hopper each position
// loads its two words and its ID directly, so no sort is needed and the
// chain is one pass.
//
// Layout: bv_words and cum_ranks are two uint32 arrays of nwords each (not
// interleaved), as MIBloomFilter keeps them; the ID plane is the filter's
// own array at its native width, so the lane extract is an element load.
//
// What bounds it on the H100: random loads. Each position reads two 4-byte
// words at the same index of two arrays (two 32-byte sectors) and, on a hit,
// one ID; at the sizes users build (10**8 bits, 4.8e7 IDs = 12 MB of words
// each and 96 MB of IDs) the arrays exceed the 50 MB L2 together. Design:
// one thread per position in a grid-stride loop, coalesced position loads
// and output stores; the ID load is skipped on a miss, where raw is 0
// anyway. Position words past the vector are clamped to its last word, as
// an XLA gather clamps.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(BTL_BLOCK)
mibf_rank_kernel(const uint32_t* __restrict__ pos, long long n,
                 const uint32_t* __restrict__ bv,
                 const uint32_t* __restrict__ cum, long long nwords,
                 const T* __restrict__ data, long long d_size,
                 int32_t* __restrict__ rank, bool* __restrict__ hit,
                 uint32_t* __restrict__ raw) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const uint32_t p = pos[i];
        long long w = p >> 5;
        if (w >= nwords) w = nwords - 1;
        const uint32_t word = __ldg(&bv[w]);
        const uint32_t bit = p & 31u;
        const uint32_t r = __ldg(&cum[w]) + __popc(word & ((1u << bit) - 1u));
        const bool h = (word >> bit) & 1u;
        rank[i] = (int32_t)r;
        hit[i] = h;
        if (raw != nullptr) {
            uint32_t v = 0;
            if (h) {
                const long long rc = (long long)r < d_size ? (long long)r
                                                           : d_size - 1;
                v = (uint32_t)__ldg(&data[rc]);
            }
            raw[i] = v;
        }
    }
}

template <typename T>
static cudaError_t launch(const void* pos, long long n, const void* bv,
                          const void* cum, long long nwords, const void* data,
                          long long d_size, void* rank, void* hit, void* raw,
                          cudaStream_t stream) {
    mibf_rank_kernel<T><<<btl_blocks(n), BTL_BLOCK, 0, stream>>>(
        (const uint32_t*)pos, n, (const uint32_t*)bv, (const uint32_t*)cum,
        nwords, (const T*)data, d_size, (int32_t*)rank, (bool*)hit,
        (uint32_t*)raw);
    return cudaGetLastError();
}

// pos uint32 [n]; bv, cum uint32 [nwords]; data [d_size] of `width` bytes
// (1, 2 or 4), or null with width 0 for rank-only mode (raw then null too);
// rank int32 [n], hit bool [n], raw uint32 [n].
extern "C" int btl_mibf_rank(const void* pos, long long n, const void* bv,
                             const void* cum, long long nwords,
                             const void* data, int width, long long d_size,
                             void* rank, void* hit, void* raw, int device,
                             void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = (cudaStream_t)stream;
    switch (width) {
        case 0:
            return (int)launch<uint32_t>(pos, n, bv, cum, nwords, nullptr, 0,
                                         rank, hit, nullptr, s);
        case 1:
            return (int)launch<uint8_t>(pos, n, bv, cum, nwords, data, d_size,
                                        rank, hit, raw, s);
        case 2:
            return (int)launch<uint16_t>(pos, n, bv, cum, nwords, data,
                                         d_size, rank, hit, raw, s);
        case 4:
            return (int)launch<uint32_t>(pos, n, bv, cum, nwords, data,
                                         d_size, rank, hit, raw, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
