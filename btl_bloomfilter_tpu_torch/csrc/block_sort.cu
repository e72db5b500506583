// Ascending unsigned sort of each consecutive block of BLOCK uint32 keys,
// block-locally (a bitonic network per block), for BLOCK 2048 and 1024.
//
// Replaces two TPU kernels that compute this one function at two sizes:
//   btl_bloomfilter_tpu/kernels/vmem_sort.py:sort_blocks (_block_kernel,
//     pallas_call at :87), 2048-key blocks held as [16, 128] in VMEM;
//   bench/partition_probe.py:chunk_bitonic (_bitonic_kernel, pallas_call
//     at :95), 1024-key chunks held as [8, 128].
// The TPU kernels build each compare-exchange stage from lane and sublane
// rolls and compare in int32 through a sign flip (uint32 min/max crashed
// Mosaic). Here the keys compare as uint32 directly, so 0x80000000 and
// 0xFFFFFFFF sort last.
//
// What bounds it on the H100: the keys are read once and written once
// (8 bytes a key), but the network does log2(B)(log2(B)+1)/2 = 66 (B =
// 2048) or 55 (B = 1024) compare-exchange stages on every key, so the
// block is compute- and synchronisation-bound, not memory-bound. Design:
// one thread block per key block, B/2 threads, each holding keys t and
// t + B/2 in registers. A stage of partner distance j exchanges through a
// warp shuffle for j < 32, through shared memory between two
// __syncthreads for 32 <= j < B/2, and between the thread's own two
// registers for j = B/2. Loads and stores are coalesced.

#include "common.cuh"

#define BTL_FULL_MASK 0xFFFFFFFFu

// The key that index i keeps after comparing its key x with its partner's
// key p at stage (k, j): the smaller when the sub-sequence of size k is
// ascending and i is the lower index of the pair, or descending and the
// upper one.
__device__ __forceinline__ uint32_t cmpx(uint32_t x, uint32_t p, int i,
                                         int j, int k) {
    const bool take_min = ((i & k) == 0) == ((i & j) == 0);
    return take_min ? min(x, p) : max(x, p);
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK / 2)
block_sort_kernel(const uint32_t* __restrict__ in,
                  uint32_t* __restrict__ out) {
    constexpr int NT = BLOCK / 2;
    __shared__ uint32_t s[BLOCK];
    const int i0 = threadIdx.x, i1 = threadIdx.x + NT;
    const long long off = (long long)blockIdx.x * BLOCK;
    uint32_t x0 = in[off + i0], x1 = in[off + i1];
#pragma unroll
    for (int k = 2; k <= BLOCK; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            uint32_t p0, p1;
            if (j == NT) {              // partner is the other register
                p0 = x1;
                p1 = x0;
            } else if (j >= 32) {       // partner in another warp
                s[i0] = x0;
                s[i1] = x1;
                __syncthreads();
                p0 = s[i0 ^ j];
                p1 = s[i1 ^ j];
                __syncthreads();
            } else {                    // partner in this warp
                p0 = __shfl_xor_sync(BTL_FULL_MASK, x0, j);
                p1 = __shfl_xor_sync(BTL_FULL_MASK, x1, j);
            }
            x0 = cmpx(x0, p0, i0, j, k);
            x1 = cmpx(x1, p1, i1, j, k);
        }
    }
    out[off + i0] = x0;
    out[off + i1] = x1;
}

// in, out uint32 [nblocks * block], block 1024 or 2048; out must not
// overlap in.
extern "C" int btl_block_sort(const void* in, void* out, long long nblocks,
                              int block, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const cudaStream_t st = (cudaStream_t)stream;
    switch (block) {
    case 1024:
        block_sort_kernel<1024><<<(unsigned)nblocks, 512, 0, st>>>(
            (const uint32_t*)in, (uint32_t*)out);
        break;
    case 2048:
        block_sort_kernel<2048><<<(unsigned)nblocks, 1024, 0, st>>>(
            (const uint32_t*)in, (uint32_t*)out);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
