// Copy sweep: dst = src as nsteps * k chunks of rows x 128 uint32 (rows *
// 512 bytes each), k chunks per grid step.
//
// Replaces: bench/partition_probe.py:dma_sweep (_dma_kernel, pallas_call at
// :132), the probe of the TPU's DMA issue cost: each grid step starts k
// small asynchronous HBM-to-HBM copies, chunk c * k + i for i < k, then
// waits for them all; the per-copy time bounds any bucket-partition pass.
//
// What bounds it on the H100: the bytes, read once and written once, if
// enough of them are in flight: at 3.35 TB/s and about 0.6-0.7 us of DRAM
// latency the card needs about 2 MiB in flight. The first design (one
// 16-byte load in flight a thread, the threads of a block striding over
// one chunk at a time) kept about 1 MiB in flight and reached 2.09 TB/s
// (NVIDIA H100 80GB HBM3, 700 W power limit).
// Hopper's form of the TPU's asynchronous copies, TMA bulk copies
// (cp.async.bulk from global into a ring of shared-memory stages on
// mbarriers, bulk stores back), was tried next and came out slower than
// one `copy_` of the same bytes, one issuing thread a block being the
// limit (PERF.md). Design: each thread issues UNROLL independent
// 16-byte loads before their stores. A grid step's k chunks lie one after
// another, so the step is one span, copied by `split` blocks, and k
// changes only the span's length. Inside L2 (the sweep's bytes under the
// device's L2 size, read at launch) one block a step is fastest; past it
// the copy is DRAM-bound and wants the card full of loads, so a step is
// split until the grid has FILL_PER_SM blocks an SM.

#include "common.cuh"

#define BTL_ROW_VECS 32              // 16-byte vectors in a 512-byte row
#define UNROLL 16                    // loads in flight a thread
#define FILL_PER_SM 16

__global__ void __launch_bounds__(BTL_BLOCK)
dma_sweep_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                 long long step_vecs, int split) {
    const long long step = blockIdx.x / split;
    const long long span = (step_vecs + split - 1) / split;
    const long long lo = step * step_vecs + blockIdx.x % split * span;
    const long long hi = min(lo + span, (step + 1) * step_vecs);
    for (long long b = lo + threadIdx.x; b < hi;
         b += (long long)BTL_BLOCK * UNROLL) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = b + (long long)u * BTL_BLOCK;
            if (i < hi) v[u] = src[i];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = b + (long long)u * BTL_BLOCK;
            if (i < hi) dst[i] = v[u];
        }
    }
}

// src, dst uint32 [nsteps * k * rows, 128], 16-byte aligned, not
// overlapping.
extern "C" int btl_dma_sweep(const void* src, void* dst, long long nsteps,
                             long long k, long long rows, int device,
                             void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    int l2_bytes = 0, sms = 0;
    err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return (int)err;
    const long long step_vecs = k * rows * BTL_ROW_VECS;
    const long long fill = (long long)sms * FILL_PER_SM;
    long long split = 1;
    if (nsteps * step_vecs * 16 > l2_bytes && nsteps < fill)
        split = fill / nsteps;
    if (nsteps * split >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    dma_sweep_kernel<<<(unsigned)(nsteps * split), BTL_BLOCK, 0,
                       (cudaStream_t)stream>>>(
        (const uint4*)src, (uint4*)dst, step_vecs, (int)split);
    return (int)cudaGetLastError();
}
