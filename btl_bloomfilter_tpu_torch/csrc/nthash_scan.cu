// Canonical ntHash of every k-mer window of a batch of reads, with the
// h-fold multi-hash derivation, N-window validity and, in positions mode,
// the reduction mod the filter size with a sentinel: uint32 positions and
// 0xFFFFFFFF below 2**32 bits, int64 positions and -1 from 2**32 bits (the
// wide form, a template instantiation of its own, so the narrow form's
// code is unchanged).
//
// Replaces: btl_bloomfilter_tpu/kernels/nthash_scan.py:_kernel (the Pallas
// kernel behind positions_planes_kernel and hash_frames_planes_kernel).
// The TPU kernel walks 128-lane column blocks in order, carrying a prefix-
// XOR from block to block, because the TPU has no 64-bit integers and
// favours long vector scans. CUDA blocks run in no order, so nothing is
// carried from block to block: each thread takes a run of R consecutive
// windows and rolls its hashes along the run with ntHash's recurrence,
//
//   fh(p+1) = srol(fh(p)) ^ srol^k(seed(s[p])) ^ seed(s[p+k])
//   rh(p+1) = sror(rh(p)) ^ sror(rcseed(s[p])) ^ srol^(k-1)(rcseed(s[p+k]))
//
// (srol: ntHash's split rotation, the low 33 and the high 31 bits rotating
// independently; sror its inverse). The two XOR terms of a step depend only
// on the pair (out, in) of base codes, so the host builds them once per k
// as two 5 x 5 tables (kernels/nthash_scan.py roll_tables; N's seed is 0;
// RollTables in nthash_roll.cuh, shared with the spaced-seed hash), and
// the kernel keeps them in shared memory. A run's first window is
// rolled in from the all-N window (hashes 0) with k steps whose out-base is
// N: the same step, with no table by offset, so any k takes one code path.
//
// What bounds it on the H100: at 512 reads x 2048 bases, k=31, h=4, it
// writes 16 B of positions (or 32 B of hashes) plus 2 B of flags per window
// against 1 B of codes read: 0.0059 ms at 3.35 TB/s. The earlier design
// computed every window from nothing, k code loads and 2k table loads from
// shared memory a window, and the load units bounded it at 4.8x that. A
// roll step is two table loads and two split rotations, so a window costs
// (k + R - 1) / R steps. Codes are read from global memory four to a load
// (R is a multiple of 4, so every lane of a block has the same alignment
// and the reload branch is uniform). The stores stay coalesced: a block
// hashes a tile of 2048 windows of one read in 2048 / R runs, stages their
// canonical hashes and flags in shared memory, then thread t derives and
// writes windows t, t + 2048 / R, ..., every plane's store contiguous
// across the warp. The mod by a non-power-of-two size is
// a Barrett multiply (magic from the host), a mask for a power of two.

#include <cstring>

#include "common.cuh"
#include "nthash_roll.cuh"

// The narrow form: size < 2**32.
__device__ __forceinline__ uint32_t mod_size(uint64_t v, uint64_t size,
                                             uint64_t magic, int shift) {
    return (uint32_t)btl_mod_size64(v, size, magic, shift);
}

// Windows a block: one tile of TILE windows of a read, in TILE / R runs.
#define TILE 2048

// One block per (read, tile); thread t < TILE / R rolls the tile's windows
// t*R .. t*R + R - 1, then every thread derives and writes windows. kWide:
// positions mode writes int64 positions with -1 as the sentinel.
template <int R, bool kWide>
__global__ void __launch_bounds__(BTL_BLOCK)
nthash_scan_kernel(const uint8_t* __restrict__ codes, long long B,
                   long long L, int k, int h, long long W,
                   long long tiles_per_row, int positions_mode,
                   uint64_t size, uint64_t magic, int shift, RollTables tab,
                   void* __restrict__ out, bool* __restrict__ strand,
                   bool* __restrict__ valid) {
    constexpr int NT = TILE / R;     // runs a tile, at most BTL_BLOCK
    // run r of thread t at s_canon[r * STRIDE + t]: the roll's stores are
    // contiguous across a warp, and the padding puts the emit phase's
    // loads (16 lanes on the R runs of one thread) in distinct banks
    constexpr int STRIDE = NT + 1;
    __shared__ uint64_t s_f[25], s_r[25];
    __shared__ uint64_t s_canon[R * STRIDE];
    __shared__ uint64_t s_flags[NT];   // 2 bits a window: strand, ok

    if (threadIdx.x < 25) {
        s_f[threadIdx.x] = tab.f[threadIdx.x];
        s_r[threadIdx.x] = tab.r[threadIdx.x];
    }
    __syncthreads();

    const long long b = blockIdx.x / tiles_per_row;
    const long long p0 = (blockIdx.x % tiles_per_row) * TILE;
    const long long p = p0 + (long long)threadIdx.x * R;
    const uint8_t* row = codes + b * L;

    const uint64_t flags =
        threadIdx.x < NT && p < W
            ? btl_roll_run<R>(row, p, W, k, s_f, s_r,
                              s_canon + threadIdx.x, STRIDE)
            : 0;
    if (threadIdx.x < NT) s_flags[threadIdx.x] = flags;
    __syncthreads();

    long long nw = W - p0;
    if (nw > TILE) nw = TILE;
    const long long plane = B * W;
    const uint64_t km = (uint64_t)k * BTL_MULTI_SEED;
    for (int w = threadIdx.x; w < nw; w += BTL_BLOCK) {
        const int t = w / R, r = w % R;
        const uint64_t canon = s_canon[r * STRIDE + t];
        const uint32_t f = (uint32_t)(s_flags[t] >> (2 * r));
        const bool ok = f & 2u;
        const long long idx = b * W + p0 + w;
        for (int i = 0; i < h; ++i) {
            const uint64_t v = btl_derive_hash(canon, i, km);
            if (kWide) {
                ((long long*)out)[i * plane + idx] =
                    ok ? (long long)btl_mod_size64(v, size, magic, shift)
                       : -1LL;
            } else if (positions_mode) {
                ((uint32_t*)out)[i * plane + idx] =
                    ok ? mod_size(v, size, magic, shift) : BTL_SENTINEL;
            } else {
                ((uint64_t*)out)[i * plane + idx] = v;
            }
        }
        strand[idx] = f & 1u;
        valid[idx] = ok;
    }
}

// codes uint8 [B, L] -> out [h, B, W], strand and valid bool [B, W], W =
// L - k + 1. positions_mode 0: uint64 hashes; 1: uint32 positions, 1 <=
// size < 2**32; 2: int64 positions, 2**32 <= size <= 2**36. Requires k >=
// 1, L >= k, h >= 1. run: windows a thread, 16 or 32. tables: the 50
// uint64 of RollTables for this k.
extern "C" int btl_nthash_scan(const void* codes, long long B, long long L,
                               int k, int h, int positions_mode,
                               unsigned long long size,
                               unsigned long long magic, int shift, int run,
                               const void* tables, void* out, void* strand,
                               void* valid, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long W = L - k + 1;
    if (B <= 0 || W <= 0) return (int)cudaGetLastError();
    if ((run != 16 && run != 32) || positions_mode < 0 || positions_mode > 2)
        return (int)cudaErrorInvalidValue;
    const long long tiles = (W + TILE - 1) / TILE;
    if (B * tiles >= (1LL << 32)) return (int)cudaErrorInvalidConfiguration;
    RollTables tab;
    memcpy(&tab, tables, sizeof tab);
    const bool wide = positions_mode == 2;
    auto kernel = run == 16 ? (wide ? nthash_scan_kernel<16, true>
                                    : nthash_scan_kernel<16, false>)
                            : (wide ? nthash_scan_kernel<32, true>
                                    : nthash_scan_kernel<32, false>);
    kernel<<<(unsigned)(B * tiles), BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, B, L, k, h, W, tiles, positions_mode,
        (uint64_t)size, (uint64_t)magic, shift, tab, out, (bool*)strand,
        (bool*)valid);
    return (int)cudaGetLastError();
}
