// Copy sweep: dst = src as nsteps * k chunks of rows x 128 uint32 (rows *
// 512 bytes each), k chunks per grid step.
//
// Replaces: bench/partition_probe.py:dma_sweep (_dma_kernel, pallas_call at
// :132), the probe of the TPU's DMA issue cost: each grid step starts k
// small asynchronous HBM-to-HBM copies, chunk c * k + i for i < k, then
// waits for them all; the per-copy time bounds any bucket-partition pass.
//
// What bounds it on the H100: the bytes, read once and written once. Design:
// one thread block per grid step copies its k chunks in order with plain
// 16-byte vector loads and stores (a row is 512 bytes, so every chunk is
// 16-byte aligned); the threads of the block stride over each chunk, so
// neighbouring threads touch neighbouring addresses. Bulk copies through
// the Tensor Memory Accelerator (cp.async.bulk) are later work.

#include "common.cuh"

#define BTL_ROW_VECS 32              // 16-byte vectors in a 512-byte row

__global__ void __launch_bounds__(BTL_BLOCK)
dma_sweep_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                 long long k, long long chunk_vecs) {
    for (long long i = 0; i < k; ++i) {
        const long long off = ((long long)blockIdx.x * k + i) * chunk_vecs;
        for (long long v = threadIdx.x; v < chunk_vecs; v += blockDim.x)
            dst[off + v] = src[off + v];
    }
}

// src, dst uint32 [nsteps * k * rows, 128], 16-byte aligned, not
// overlapping.
extern "C" int btl_dma_sweep(const void* src, void* dst, long long nsteps,
                             long long k, long long rows, int device,
                             void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    dma_sweep_kernel<<<(unsigned)nsteps, BTL_BLOCK, 0,
                       (cudaStream_t)stream>>>(
        (const uint4*)src, (uint4*)dst, k, rows * BTL_ROW_VECS);
    return (int)cudaGetLastError();
}
