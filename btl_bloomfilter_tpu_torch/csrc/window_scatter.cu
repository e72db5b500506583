// Static-window Bloom scatter: for each 16384-word window w of the filter,
// words | the bits of the positions of the chunks idx[s, w] (s < slots;
// 1024 sorted positions a chunk) whose word lies in w.
//
// Replaces: bench/kernel_lab.py:build (make_kernel, pallas_call at :117),
// the probe of the TPU's static-window scatter. Its grid walks the windows
// and scalar-prefetches each window's chunk indices; the variants rowmaj
// and lanemaj are two MXU one-hot formulations of one function, and null
// loads and stores the window (the pipeline floor). Here `scatter` stands
// for rowmaj and lanemaj, `null` stays the floor. A position that the
// window's chunks do not reach is dropped, as on the TPU: with uniform
// positions 4 slots cover a window, and the probe's popcount line says
// whether they did.
//
// What bounds it on the H100: the filter is read and written once, 64 KiB
// a window, and the window's positions are read once; the bit updates stay
// in shared memory. Design, the tile-local form of the Bloom insert: one
// thread block owns one window in dynamic shared memory (64 KiB, above the
// 48 KiB default, so the launch raises the limit first), loads it with
// 16-byte vector loads, applies its chunks' positions with shared-memory
// atomicOr (a chunk equal to its predecessor slot, a sentinel or a word
// outside the window skipped), and writes the window back. Each window
// belongs to one block, so the filter is updated in place without global
// atomics.

#include "common.cuh"

#define BTL_WIN_WORDS 16384          // words per window (64 KiB)
#define BTL_CHUNK 1024               // positions per chunk
#define BTL_WS_THREADS 512

__global__ void __launch_bounds__(BTL_WS_THREADS)
window_scatter_kernel(const int* __restrict__ idx, int slots, long long nwin,
                      const uint32_t* __restrict__ pos, long long nchunks,
                      unsigned int* __restrict__ words, int scatter) {
    extern __shared__ uint4 win4[];
    unsigned int* win = reinterpret_cast<unsigned int*>(win4);
    const long long w = blockIdx.x;
    uint4* g = reinterpret_cast<uint4*>(words + w * BTL_WIN_WORDS);
    for (int i = threadIdx.x; i < BTL_WIN_WORDS / 4; i += blockDim.x)
        win4[i] = g[i];
    if (scatter) {
        __syncthreads();
        const long long lo = w * BTL_WIN_WORDS;
        for (int s = 0; s < slots; ++s) {
            const int c = idx[s * nwin + w];
            if (s > 0 && c == idx[(s - 1) * nwin + w]) continue;
            if (c < 0 || c >= nchunks) continue;
            const uint32_t* cp = pos + (long long)c * BTL_CHUNK;
            for (int i = threadIdx.x; i < BTL_CHUNK; i += blockDim.x) {
                const uint32_t p = cp[i];
                if (p == BTL_SENTINEL) continue;
                const long long local = (long long)(p >> 5) - lo;
                if (local < 0 || local >= BTL_WIN_WORDS) continue;
                atomicOr(&win[local], 1u << (p & 31));
            }
        }
        __syncthreads();
    }
    // in the null variant each thread stores what it loaded: no barrier
    for (int i = threadIdx.x; i < BTL_WIN_WORDS / 4; i += blockDim.x)
        g[i] = win4[i];
}

// idx int32 [slots, nwin]; pos uint32 [nchunks * 1024]; words uint32
// [nwin * 16384], 16-byte aligned, updated in place. scatter 0 is the
// null variant.
extern "C" int btl_window_scatter(const void* idx, int slots, long long nwin,
                                  const void* pos, long long nchunks,
                                  void* words, int scatter, int device,
                                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const int smem = BTL_WIN_WORDS * 4;
    err = cudaFuncSetAttribute(window_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    window_scatter_kernel<<<(unsigned)nwin, BTL_WS_THREADS, smem,
                            (cudaStream_t)stream>>>(
        (const int*)idx, slots, nwin, (const uint32_t*)pos, nchunks,
        (unsigned int*)words, scatter);
    return (int)cudaGetLastError();
}
