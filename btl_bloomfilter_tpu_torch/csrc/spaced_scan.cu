// Spaced-seed ntHash of every k-window of a batch of reads: the
// stHashIterator's m seeds x m2 hashes a window, seed-major, with a strand
// flag a hash and N-window validity.
//
// Replaces: btl_bloomfilter_tpu/ops/seeds.py:spaced_hash_frames, which the
// JAX package runs as fused XLA under jax.jit (its api.HashPipeline with
// seeds). It has no Pallas twin: the TPU computes it as a prefix-XOR scan
// of every window's fh / rh and then, for each seed's masked offsets, one
// statically rotated, shifted slice of the per-base seeds XORed in.
//
// Design: one thread a window, in a grid-stride loop. The window's
// unmasked hashes are the closed forms
//
//   fh = XOR_i srol^(k-1-i)(seed(s[p+i])),  rh = XOR_i srol^i(rcseed(s[p+i]))
//
// (srol: ntHash's split rotation), read term by term from two tables by
// (offset, base code) that the host builds once per k
// (kernels/spaced_scan.py offset_tables; N's seed is 0, so its terms are
// 0). The same pass counts the window's Ns. Each seed's hashes are then fh
// and rh with the terms of its masked offsets XORed out again: one more
// table pair read a masked offset. The canonical hash is the smaller
// (rs < fs unsigned picks the reverse strand), and the m2 hashes derive
// from it with btl_derive_hash, the code the ntHash kernel uses. Any k
// takes this path: the tables (80 B an offset) sit in shared memory up to
// SHARED_TABLE_MAX bytes and are read from global memory (L1 / L2) past
// it.
//
// What bounds it on the H100: at 512 reads x 2048 bases, k = 31, two
// seeds, m2 = 2, it writes 4 x 8 B of hashes, 4 B of strand flags and 1 B
// of validity a window against 1 B of codes read: 0.0117 ms at 3.35 TB/s.
// A window costs k + (masked offsets) steps of one code load (coalesced
// across the warp: neighbouring threads take neighbouring windows) and two
// shared-memory loads, so the load units, not the bytes, bound this
// simple design; the rolled runs of csrc/nthash_scan.cu would cut a
// window to one step, a later redesign.

#include "common.cuh"

#define CODE_N 4
// the largest table pair kept in shared memory (k up to 2560)
#define SHARED_TABLE_MAX (200 * 1024)

__global__ void __launch_bounds__(BTL_BLOCK)
spaced_scan_kernel(const uint8_t* __restrict__ codes, long long L, int k,
                   long long W, long long n, int m, int m2,
                   const uint64_t* __restrict__ gtab, int tab_shared,
                   const int* __restrict__ zinfo,
                   uint64_t* __restrict__ out, bool* __restrict__ strand,
                   bool* __restrict__ valid) {
    extern __shared__ uint64_t s_tab[];
    const uint64_t* tab = gtab;
    if (tab_shared) {
        for (int i = threadIdx.x; i < 10 * k; i += blockDim.x)
            s_tab[i] = gtab[i];
        __syncthreads();
        tab = s_tab;
    }
    const uint64_t* tf = tab;            // srol^(k-1-i)(seed(c)) at i*5+c
    const uint64_t* tr = tab + 5 * k;    // srol^i(rcseed(c)) at i*5+c
    const uint64_t km = (uint64_t)k * BTL_MULTI_SEED;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < n; idx += stride) {
        const long long b = idx / W;
        const uint8_t* w = codes + b * L + (idx - b * W);
        uint64_t fh = 0, rh = 0;
        int n_count = 0;
        for (int i = 0; i < k; ++i) {
            const uint32_t c0 = __ldg(w + i);
            const int c = c0 < 4 ? (int)c0 : CODE_N;
            fh ^= tf[i * 5 + c];
            rh ^= tr[i * 5 + c];
            n_count += c == CODE_N;
        }
        valid[idx] = n_count == 0;
        for (int s = 0; s < m; ++s) {
            uint64_t fs = fh, rs = rh;
            const int z1 = __ldg(zinfo + s + 1);
            for (int z = __ldg(zinfo + s); z < z1; ++z) {
                const int i = __ldg(zinfo + m + 1 + z);
                const uint32_t c0 = __ldg(w + i);
                const int c = c0 < 4 ? (int)c0 : CODE_N;
                fs ^= tf[i * 5 + c];
                rs ^= tr[i * 5 + c];
            }
            const bool st = rs < fs;       // reverse strand canonical
            const uint64_t canon = st ? rs : fs;
            for (int j = 0; j < m2; ++j) {
                const long long o = (long long)(s * m2 + j) * n + idx;
                out[o] = btl_derive_hash(canon, j, km);
                strand[o] = st;
            }
        }
    }
}

// codes uint8 [B, L] -> out uint64 [m * m2, B, W] and strand bool
// [m * m2, B, W], seed-major, valid bool [B, W], W = L - k + 1. Requires
// k >= 1, L >= k, m >= 1, m2 >= 1. tables: the 10 k uint64 of
// offset_tables(k) on the card (forward terms, then reverse terms). zinfo:
// int32 [m + 1 + Z], each seed's first index into the masked offsets, then
// the Z masked offsets of all seeds in order.
extern "C" int btl_spaced_scan(const void* codes, long long B, long long L,
                               int k, int m, int m2, const void* tables,
                               const void* zinfo, void* out, void* strand,
                               void* valid, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (k < 1 || m < 1 || m2 < 1) return (int)cudaErrorInvalidValue;
    const long long W = L - k + 1;
    if (B <= 0 || W <= 0) return (int)cudaGetLastError();
    const long long bytes = 80LL * k;
    const int tab_shared = bytes <= SHARED_TABLE_MAX;
    const size_t smem = tab_shared ? (size_t)bytes : 0;
    if (smem > 48 * 1024) {   // k > 614: past the default limit
        err = cudaFuncSetAttribute(spaced_scan_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long n = B * W;
    spaced_scan_kernel<<<btl_blocks(n), BTL_BLOCK, smem,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)codes, L, k, W, n, m, m2, (const uint64_t*)tables,
        tab_shared, (const int*)zinfo, (uint64_t*)out, (bool*)strand,
        (bool*)valid);
    return (int)cudaGetLastError();
}
