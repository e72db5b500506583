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
// Design: a seed's hashes are the window's unmasked ntHash pair
//
//   fh = XOR_i srol^(k-1-i)(seed(s[p+i])),  rh = XOR_i srol^i(rcseed(s[p+i]))
//
// (srol: ntHash's split rotation; N's seed is 0) with the terms of the
// seed's masked offsets XORed out again. One block takes a tile of TILE
// windows of one read and first copies into shared memory the tile's
// bases (four to an aligned 32-bit load, codes past 3 as N), the seeds'
// masked offsets and each masked offset's row of the per-k tables
// (kernels/spaced_scan.py masked_tables: its 5 forward and 5 reverse terms
// by base code, 80 B). The unmasked pair rolls as in csrc/nthash_scan.cu,
// with its roll tables and split rotations (nthash_roll.cuh): each of the
// block's first TILE / R threads rolls a run of R consecutive windows in
// from the all-N window (k steps), then one roll step a window, reading
// the bases from shared memory and staging fh, rh and the N-window flag
// there. Then every thread takes windows t, t + 256, ...: per seed, one
// forward and one reverse term a masked offset, looked up by the base at
// that offset; the canonical hash is the smaller (rs < fs unsigned picks
// the reverse strand), the m2 hashes derive from it with btl_derive_hash
// (common.cuh), and every plane's store is contiguous across the warp.
// Past SHARED_MAX bytes of rows and bases (a k of thousands with many
// masked offsets), the same code reads them from global memory.
//
// What bounds it on the H100: at 512 reads x 2048 bases, k = 31, two
// seeds, m2 = 2, it writes 4 x 8 B of hashes, 4 B of strand flags and 1 B
// of validity a window against 1 B of codes read: 0.0117 ms at 3.35 TB/s.
// A window costs (k + R - 1) / R roll steps (two table loads each) and,
// per masked offset, one base and two table loads from shared memory (8
// masked offsets at those seeds), against k + 8 load steps in the first
// design, which computed every window from nothing. What is left is
// mostly the stores, which a block issues only after its copy and roll
// phases: tiles of 1024 windows (two blocks a read) overlap one block's
// stores with another's roll a little better than 2048 or 512 (PERF.md
// section 6).

#include <cstring>

#include "common.cuh"
#include "nthash_roll.cuh"

// Windows a block: one tile of TILE windows of a read, in TILE / R runs.
#define TILE 1024
// dynamic shared memory for the masked rows, the seed info and the tile's
// bases, at most
#define SHARED_MAX (160 * 1024)

template <int R>
__global__ void __launch_bounds__(BTL_BLOCK)
spaced_scan_kernel(const uint8_t* __restrict__ codes, long long B,
                   long long L, int k, long long W, long long tiles_per_row,
                   int m, int m2, RollTables tab,
                   const uint64_t* __restrict__ masked,
                   const int* __restrict__ zinfo, int nz, int use_shared,
                   uint64_t* __restrict__ out, bool* __restrict__ strand,
                   bool* __restrict__ valid) {
    constexpr int NT = TILE / R;     // runs a tile, at most BTL_BLOCK
    // run r of thread t at [r * STRIDE + t], as in nthash_scan.cu
    constexpr int STRIDE = NT + 1;
    __shared__ uint64_t s_f[25], s_r[25];
    __shared__ uint64_t s_fh[R * STRIDE], s_rh[R * STRIDE];
    __shared__ uint32_t s_ok[NT];    // a bit a window: no N
    // the masked rows, the seed info, then the bases
    extern __shared__ uint64_t s_dyn[];

    const long long b = blockIdx.x / tiles_per_row;
    const long long p0 = (blockIdx.x % tiles_per_row) * TILE;
    const uint8_t* row = codes + b * L;
    long long nw = W - p0;
    if (nw > TILE) nw = TILE;

    if (threadIdx.x < 25) {
        s_f[threadIdx.x] = tab.f[threadIdx.x];
        s_r[threadIdx.x] = tab.r[threadIdx.x];
    }
    // the rows of the masked offsets (forward terms by base, then
    // reverse), the seed info and the tile's bases, codes past 3 as N
    const uint64_t* rows = masked;
    const int* zi = zinfo;
    const uint8_t* bases = row + p0;
    if (use_shared) {
        for (int i = threadIdx.x; i < 10 * nz; i += BTL_BLOCK)
            s_dyn[i] = masked[i];
        int* si = (int*)(s_dyn + 10 * nz);
        for (int i = threadIdx.x; i < m + 1 + nz; i += BTL_BLOCK)
            si[i] = zinfo[i];
        uint8_t* sb = (uint8_t*)(si + m + 1 + nz);
        // four bases to an aligned 32-bit load (no load reaches past the
        // word that holds the tile's last base)
        const int nb = (int)nw + k - 1;
        const uintptr_t a = (uintptr_t)(row + p0);
        const uint32_t* w4 = (const uint32_t*)(a & ~(uintptr_t)3);
        const int off = (int)(a & 3);
        for (int i = threadIdx.x; 4 * i < nb + off; i += BTL_BLOCK) {
            const uint32_t v = __ldg(w4 + i);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int j = 4 * i + q - off;
                const uint32_t c = (v >> (8 * q)) & 0xFFu;
                if (j >= 0 && j < nb)
                    sb[j] = c < 4 ? (uint8_t)c : (uint8_t)CODE_N;
            }
        }
        rows = s_dyn;
        zi = si;
        bases = sb;
    }
    __syncthreads();

    // the base at offset j of the tile, N for a code past 3
    auto code = [&](int j) -> int {
        const uint32_t c = bases[j];
        return c < 4 ? (int)c : CODE_N;
    };
    const int q0 = threadIdx.x * R;
    const long long p = p0 + q0;
    if (threadIdx.x < NT && p < W) {
        // roll in from the all-N window: k steps whose out-base is N
        uint64_t fh = 0, rh = 0;
        int n_count = 0;
        for (int j = 0; j < k; ++j) {
            const int c = code(q0 + j);
            fh = srol1(fh) ^ s_f[CODE_N * 5 + c];
            rh = sror1(rh) ^ s_r[CODE_N * 5 + c];
            n_count += c == CODE_N;
        }
        uint32_t ok = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if (p + r >= W) break;
            s_fh[r * STRIDE + threadIdx.x] = fh;
            s_rh[r * STRIDE + threadIdx.x] = rh;
            ok |= (uint32_t)(n_count == 0) << r;
            if (r + 1 < R && p + r + 1 < W) {
                const int o = code(q0 + r), i = code(q0 + r + k);
                fh = srol1(fh) ^ s_f[o * 5 + i];
                rh = sror1(rh) ^ s_r[o * 5 + i];
                n_count += (i == CODE_N) - (o == CODE_N);
            }
        }
        s_ok[threadIdx.x] = ok;
    }
    __syncthreads();

    const long long plane = B * W;
    const uint64_t km = (uint64_t)k * BTL_MULTI_SEED;
    for (int w = threadIdx.x; w < nw; w += BTL_BLOCK) {
        const int t = w / R, r = w % R;
        const uint64_t fh = s_fh[r * STRIDE + t], rh = s_rh[r * STRIDE + t];
        const long long idx = b * W + p0 + w;
        for (int s = 0; s < m; ++s) {
            uint64_t fs = fh, rs = rh;
            const int z1 = zi[s + 1];
            for (int z = zi[s]; z < z1; ++z) {
                const int c = code(w + zi[m + 1 + z]);
                fs ^= rows[z * 10 + c];
                rs ^= rows[z * 10 + 5 + c];
            }
            const bool st = rs < fs;       // reverse strand canonical
            const uint64_t canon = st ? rs : fs;
            for (int j = 0; j < m2; ++j) {
                const long long o = (long long)(s * m2 + j) * plane + idx;
                out[o] = btl_derive_hash(canon, j, km);
                strand[o] = st;
            }
        }
        valid[idx] = (s_ok[t] >> r) & 1u;
    }
}

// codes uint8 [B, L] -> out uint64 [m * m2, B, W] and strand bool
// [m * m2, B, W], seed-major, valid bool [B, W], W = L - k + 1. Requires
// k >= 1, L >= k, m >= 1, m2 >= 1. run: windows a thread, 16 or 32.
// tables: the 50 uint64 of RollTables for this k (host memory). masked: nz
// rows of 10 uint64 on the card, the masked offsets' forward terms by base
// code, then their reverse terms. zinfo: int32 [m + 1 + nz] on the card,
// each seed's first index into the masked offsets, then the nz masked
// offsets of all seeds in order.
extern "C" int btl_spaced_scan(const void* codes, long long B, long long L,
                               int k, int m, int m2, int run,
                               const void* tables, const void* masked,
                               const void* zinfo, int nz, void* out,
                               void* strand, void* valid, int device,
                               void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (k < 1 || m < 1 || m2 < 1 || nz < 0 || (run != 16 && run != 32))
        return (int)cudaErrorInvalidValue;
    const long long W = L - k + 1;
    if (B <= 0 || W <= 0) return (int)cudaGetLastError();
    const long long tiles = (W + TILE - 1) / TILE;
    if (B * tiles >= (1LL << 32)) return (int)cudaErrorInvalidConfiguration;
    RollTables tab;
    memcpy(&tab, tables, sizeof tab);
    const long long bytes = 80LL * nz + 4LL * (m + 1 + nz) + TILE + k - 1;
    const int use_shared = bytes <= SHARED_MAX;
    const size_t smem = use_shared ? (size_t)bytes : 0;
    auto kernel = run == 16 ? spaced_scan_kernel<16> : spaced_scan_kernel<32>;
    if (smem > 24 * 1024) {  // the static arrays take under 24 KB
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)(B * tiles), BTL_BLOCK, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, B, L, k, W, tiles, m, m2, tab,
        (const uint64_t*)masked, (const int*)zinfo, nz, use_shared,
        (uint64_t*)out, (bool*)strand, (bool*)valid);
    return (int)cudaGetLastError();
}
