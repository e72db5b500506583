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
// in shared memory. Design: scatter is sector-only, one thread block a
// window: the block builds the window's new bits from zero in shared
// memory (64 KiB, above the 48 KiB default, so the launch raises the limit
// first), 16-byte vectors of its chunks' positions loaded together with
// their chunk indices (a chunk equal to its predecessor slot, a chunk
// index outside the positions, a sentinel or a word outside the window
// skipped), and ORs each word that gains a bit into the filter with an
// atomicOr whose result is unused, so no load comes back to the block and
// the sectors that gain nothing are never moved. null loads each window
// into shared memory (tile_stream.cuh) and stores it back. Each window
// belongs to one block, so nothing else writes its words. Measured and not
// kept (PERF.md): the window loaded, applied and stored by one block (its
// chunks loaded while the window is in flight), and a persistent grid
// streaming windows through a ring of three buffers.

#include "tile_stream.cuh"

#define BTL_WIN_WORDS 16384          // words per window (64 KiB)
#define BTL_CHUNK 1024               // positions per chunk
#define BTL_CHUNK_VECS (BTL_CHUNK / 4)
#define BTL_WS_UNROLL 4              // position vectors in flight a thread

static_assert(BTL_WIN_WORDS == BTL_TILE_WORDS, "a window is a tile");

// OR the bits of window w's chunks into s, the window's words in shared
// memory: every thread takes 16-byte vectors of the slots' chunks,
// BTL_WS_UNROLL of them with their chunk indices loaded together; a chunk
// equal to its predecessor slot, a chunk index outside [0, nchunks), the
// sentinel and a word outside the window add nothing.
__device__ __forceinline__ void window_apply(const int* __restrict__ idx,
                                             int slots, long long nwin,
                                             const uint32_t* __restrict__ pos,
                                             long long nchunks, long long w,
                                             uint32_t* s) {
    const uint4* pos4 = reinterpret_cast<const uint4*>(pos);
    const long long lo = w * BTL_WIN_WORDS;
    const int nvec = slots * BTL_CHUNK_VECS;
    for (int v0 = threadIdx.x; v0 < nvec;
         v0 += BTL_WS_UNROLL * blockDim.x) {
        uint4 q[BTL_WS_UNROLL];
#pragma unroll
        for (int j = 0; j < BTL_WS_UNROLL; ++j) {
            const int v = v0 + j * blockDim.x;
            q[j] = make_uint4(BTL_SENTINEL, BTL_SENTINEL, BTL_SENTINEL,
                              BTL_SENTINEL);
            if (v < nvec) {
                const int sl = v / BTL_CHUNK_VECS;
                const int c = idx[sl * nwin + w];
                const int prev = sl > 0 ? idx[(sl - 1) * nwin + w] : -1;
                if (c != prev && c >= 0 && c < nchunks)
                    q[j] = pos4[(long long)c * BTL_CHUNK_VECS
                                + v % BTL_CHUNK_VECS];
            }
        }
#pragma unroll
        for (int j = 0; j < BTL_WS_UNROLL; ++j) {
            const uint32_t p[4] = {q[j].x, q[j].y, q[j].z, q[j].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const long long local = (long long)(p[k] >> 5) - lo;
                if (p[k] != BTL_SENTINEL && local >= 0
                    && local < BTL_WIN_WORDS)
                    atomicOr(&s[local], 1u << (p[k] & 31));
            }
        }
    }
    __syncthreads();
}

// null: each window loaded into shared memory and stored back.
__global__ void __launch_bounds__(BTL_TILE_THREADS)
window_null(uint32_t* words) {
    extern __shared__ uint4 win4[];
    uint32_t* s = reinterpret_cast<uint32_t*>(win4);
    uint32_t* g = words + blockIdx.x * (long long)BTL_WIN_WORDS;
    btl_stream_load(s, g, BTL_WIN_WORDS);
    btl_cp_async_wait<0>();
    __syncthreads();
    btl_tile_copy<false>(s, g, BTL_WIN_WORDS);
}

// scatter: one block a window builds the window's new bits from zero in
// shared memory, then ORs each word that gains a bit into the filter.
__global__ void __launch_bounds__(BTL_TILE_THREADS)
window_scatter_kernel(const int* __restrict__ idx, int slots,
                      long long nwin, const uint32_t* __restrict__ pos,
                      long long nchunks, unsigned int* __restrict__ words) {
    extern __shared__ uint4 delta4[];
    uint32_t* delta = reinterpret_cast<uint32_t*>(delta4);
    const long long w = blockIdx.x;
    for (int i = threadIdx.x; i < BTL_WIN_WORDS / 4; i += blockDim.x)
        delta4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    window_apply(idx, slots, nwin, pos, nchunks, w, delta);
    unsigned int* g = words + w * BTL_WIN_WORDS;
    for (int i = threadIdx.x; i < BTL_WIN_WORDS; i += blockDim.x) {
        const uint32_t d = delta[i];
        if (d) atomicOr(&g[i], d);
    }
}

// idx int32 [slots, nwin]; pos uint32 [nchunks * 1024], 16-byte aligned;
// words uint32 [nwin * 16384], 16-byte aligned, updated in place. scatter
// 0 is the null variant.
extern "C" int btl_window_scatter(const void* idx, int slots, long long nwin,
                                  const void* pos, long long nchunks,
                                  void* words, int scatter, int device,
                                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    static unsigned long long smem_set = 0, smem_null = 0;
    if (scatter) {
        err = btl_allow_smem(window_scatter_kernel, BTL_WIN_WORDS * 4,
                             device, &smem_set);
        if (err != cudaSuccess) return (int)err;
        window_scatter_kernel<<<(unsigned)nwin, BTL_TILE_THREADS,
                                BTL_WIN_WORDS * 4, st>>>(
            (const int*)idx, slots, nwin, (const uint32_t*)pos, nchunks,
            (unsigned int*)words);
        return (int)cudaGetLastError();
    }
    err = btl_allow_smem(window_null, BTL_WIN_WORDS * 4, device, &smem_null);
    if (err != cudaSuccess) return (int)err;
    window_null<<<(unsigned)nwin, BTL_TILE_THREADS, BTL_WIN_WORDS * 4, st>>>(
        (uint32_t*)words);
    return (int)cudaGetLastError();
}
