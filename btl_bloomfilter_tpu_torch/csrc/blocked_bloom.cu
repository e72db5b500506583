// Blocked Bloom filter insert and query: every k-mer's h bits lie in one
// 512-bit block (16 words, one 64-byte line) of the filter, rows [nblocks,
// 16]. From the k-mer's canonical hash c:
//   block = c mod nblocks,  bit j = derive(c, j) & 511 for j = 1..h
// (derive the ntHash multi-hash, btl_derive_hash; slot 0 is c itself and
// picks the block).
//
// Replaces: btl_bloomfilter_tpu/models/blocked.py insert and contains.
// No Pallas kernel there: the JAX package turns the blocked insert into
// global bit positions and runs them through the classic path's sort,
// dedupe and sorted-delta scatter, and the query into an XLA row gather
// with 16 lane selects. The JAX positions are uint32 with 0xFFFFFFFF as the
// sentinel, so at exactly 2**32 bits it drops bit 2**32 - 1; here there are
// no positions, so that bit is set like any other (a block index and a
// word of its row, in 64 bits).
//
// What bounds it on the H100: one random 64-byte line a k-mer, far beyond
// the 50 MB L2 at 2**30 bits (128 MiB, 2**21 lines): two 32-byte sectors of
// the line at most, where the classic filter's h bits touch h lines.
//
// The query (one thread a k-mer in a grid-stride loop): the canonical
// hashes and the valid flags load coalesced; the block is a Barrett modulo
// (kernels/nthash_scan.py barrett); the h bits become 16 word masks in
// registers (a compare-select a word, no indexed register array, so nothing
// spills to local memory); the line comes in as four 16-byte read-only
// loads and every mask is tested; an invalid k-mer loads nothing.
//
// The insert. An atomic to a line that is not in L2 waits there on the
// line's DRAM fill, an atomic whose bits are all set already costs as much
// as any other, and a poly-A read's windows, all one canonical hash, would
// serialise their atomics on the same few words. So four lanes take a
// k-mer, each one 16 bytes (two 64-bit words) of its line:
//   * fill before modify: each lane first loads its 16 bytes through L2
//     (ld.global.cg, which also sees the reductions of other SMs), up to
//     UNROLL k-mers a lane at once, so many lines' fills are in flight;
//   * then a fire-and-forget 64-bit reduction (red.global.or.b64) only for
//     a word whose mask bits are not all set already: a k-mer whose bits
//     are all set issues none (a repeated k-mer, a batch inserted twice);
//     8 words a line make 8 (1 - (7/8)**h) reductions a k-mer on an empty
//     line, against 16 (1 - (15/16)**h) of 32-bit ones (3.31 against 3.64
//     at h = 4);
//   * a valid k-mer equal to the one just before it in the warp (the
//     window before it: a poly-A read, a tandem repeat) adds nothing and is
//     skipped without a load.
// From zeroed rows it is bound by the DRAM traffic of its random rows (the
// fills and the dirty rows' write-back), not by the reductions: plain
// stores in their place take as long (PERF.md). The same device
// code serves the insert of canonical hashes and the fused insert of a
// read batch, which rolls ntHash as csrc/nthash_scan.cu does
// (nthash_roll.cuh), stages a tile's canonical hashes and flags in shared
// memory and inserts them from there: no hash goes to global memory.

#include <cstring>

#include "common.cuh"
#include "nthash_roll.cuh"

#define BLOCKED_WORDS 16

// The 16 word masks of a k-mer's h in-block bits.
__device__ __forceinline__ void blocked_masks(uint64_t canon, int h,
                                              uint64_t km,
                                              uint32_t m[BLOCKED_WORDS]) {
#pragma unroll
    for (int w = 0; w < BLOCKED_WORDS; ++w) m[w] = 0u;
    for (int j = 1; j <= h; ++j) {
        const uint32_t bit = (uint32_t)btl_derive_hash(canon, j, km) & 511u;
        const uint32_t word = bit >> 5, b = 1u << (bit & 31u);
#pragma unroll
        for (int w = 0; w < BLOCKED_WORDS; ++w)
            m[w] |= word == (uint32_t)w ? b : 0u;
    }
}

// k-mers a lane takes at once in the insert: their line loads are in
// flight together
#define UNROLL 4
// windows a block of the fused insert hashes (TILE in nthash_scan.cu)
#define SEQ_TILE 2048
// k-mers a block of the insert takes at once: four lanes each
#define KMERS_A_PASS (BTL_BLOCK / 4)

// The insert of UNROLL k-mers, each by the four lanes of its group (lane
// sub = threadIdx.x & 3 takes 64-bit words 2 sub and 2 sub + 1 of the
// line). All 32 lanes of the warp call it together (the shuffles); ok[u]
// false: no k-mer there, or an invalid one.
__device__ __forceinline__ void blocked_insert_lanes(
        unsigned long long* __restrict__ rows, const uint64_t (&c)[UNROLL],
        const bool (&ok)[UNROLL], uint64_t nblocks, uint64_t magic,
        int shift, int h, uint64_t km) {
    const int sub = threadIdx.x & 3;
    const bool first = (threadIdx.x & 31) < 4;   // no group before it
    unsigned long long* word[UNROLL];
    uint64_t m0[UNROLL], m1[UNROLL];
    uint4 cur[UNROLL];
    bool go[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const uint64_t pc = __shfl_up_sync(0xFFFFFFFFu, c[u], 4);
        const bool pok = __shfl_up_sync(0xFFFFFFFFu, (int)ok[u], 4);
        go[u] = ok[u] && (first || !pok || pc != c[u]);
        m0[u] = m1[u] = 0;
        if (go[u]) {
            for (int j = 1; j <= h; ++j) {
                const uint32_t bit =
                    (uint32_t)btl_derive_hash(c[u], j, km) & 511u;
                const uint64_t b = 1ULL << (bit & 63u);
                const uint32_t w = bit >> 6;
                m0[u] |= w == 2u * sub ? b : 0;
                m1[u] |= w == 2u * sub + 1 ? b : 0;
            }
            word[u] = rows + btl_mod_size64(c[u], nblocks, magic, shift) * 8
                      + 2 * sub;
            cur[u] = __ldcg(reinterpret_cast<const uint4*>(word[u]));
        }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        if (!go[u]) continue;
        const uint64_t w0 = cur[u].x | (uint64_t)cur[u].y << 32;
        const uint64_t w1 = cur[u].z | (uint64_t)cur[u].w << 32;
        if (m0[u] & ~w0) atomicOr(word[u], m0[u]);
        if (m1[u] & ~w1) atomicOr(word[u] + 1, m1[u]);
    }
}

// Canonical hashes: group g of the grid's `groups` takes k-mers g, g +
// groups, g + 2 groups, ..., UNROLL of them a pass; the loop bound is the
// warp's, so every lane of a warp reaches the shuffles.
__global__ void __launch_bounds__(BTL_BLOCK)
blocked_insert_kernel(const uint64_t* __restrict__ canon,
                      const bool* __restrict__ valid, long long n,
                      unsigned long long* __restrict__ rows,
                      uint64_t nblocks, uint64_t magic, int shift, int h,
                      uint64_t km) {
    const long long groups = (long long)gridDim.x * KMERS_A_PASS;
    const long long warp0 =
        (long long)blockIdx.x * KMERS_A_PASS + (threadIdx.x & ~31) / 4;
    const long long g = (long long)blockIdx.x * KMERS_A_PASS
                        + threadIdx.x / 4;
    for (long long base = 0; warp0 + base < n; base += UNROLL * groups) {
        uint64_t c[UNROLL];
        bool ok[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long i = g + base + u * groups;
            ok[u] = i < n && (valid == nullptr || valid[i]);
            c[u] = ok[u] ? canon[i] : 0;
        }
        blocked_insert_lanes(rows, c, ok, nblocks, magic, shift, h, km);
    }
}

// The fused insert of a read batch: one block a (read, tile of SEQ_TILE
// windows); its first SEQ_TILE / R threads roll a run of R windows each
// into shared memory (as nthash_scan_kernel), then every group of four
// lanes inserts windows g, g + KMERS_A_PASS, ... of the tile, UNROLL at a
// time.
template <int R>
__global__ void __launch_bounds__(BTL_BLOCK)
blocked_insert_seq_kernel(const uint8_t* __restrict__ codes, long long L,
                          int k, long long W, long long tiles_per_row,
                          RollTables tab,
                          unsigned long long* __restrict__ rows,
                          uint64_t nblocks, uint64_t magic, int shift, int h,
                          uint64_t km) {
    constexpr int NT = SEQ_TILE / R;   // runs a tile, at most BTL_BLOCK
    constexpr int STRIDE = NT + 1;     // as nthash_scan_kernel's
    __shared__ uint64_t s_f[25], s_r[25];
    __shared__ uint64_t s_canon[R * STRIDE];
    __shared__ uint64_t s_flags[NT];

    if (threadIdx.x < 25) {
        s_f[threadIdx.x] = tab.f[threadIdx.x];
        s_r[threadIdx.x] = tab.r[threadIdx.x];
    }
    __syncthreads();

    const long long b = blockIdx.x / tiles_per_row;
    const long long p0 = (blockIdx.x % tiles_per_row) * SEQ_TILE;
    const long long p = p0 + (long long)threadIdx.x * R;
    const uint64_t flags =
        threadIdx.x < NT && p < W
            ? btl_roll_run<R>(codes + b * L, p, W, k, s_f, s_r,
                              s_canon + threadIdx.x, STRIDE)
            : 0;
    if (threadIdx.x < NT) s_flags[threadIdx.x] = flags;
    __syncthreads();

    long long nw = W - p0;
    if (nw > SEQ_TILE) nw = SEQ_TILE;
    const int g = threadIdx.x / 4;
    for (int w0 = 0; w0 < nw; w0 += UNROLL * KMERS_A_PASS) {
        uint64_t c[UNROLL];
        bool ok[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int w = w0 + u * KMERS_A_PASS + g;
            const int t = w / R, r = w % R;
            ok[u] = w < nw && ((s_flags[t] >> (2 * r + 1)) & 1u);
            c[u] = ok[u] ? s_canon[r * STRIDE + t] : 0;
        }
        blocked_insert_lanes(rows, c, ok, nblocks, magic, shift, h, km);
    }
}

__global__ void __launch_bounds__(BTL_BLOCK)
blocked_contains_kernel(const uint64_t* __restrict__ canon,
                        const bool* __restrict__ valid, long long n,
                        const unsigned int* __restrict__ rows,
                        uint64_t nblocks, uint64_t magic, int shift, int h,
                        uint64_t km, bool* __restrict__ hit) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        if (valid != nullptr && !valid[i]) {
            hit[i] = false;
            continue;
        }
        const uint64_t c = canon[i];
        const uint4* line = reinterpret_cast<const uint4*>(
            rows + btl_mod_size64(c, nblocks, magic, shift) * BLOCKED_WORDS);
        const uint4 q0 = __ldg(line), q1 = __ldg(line + 1);
        const uint4 q2 = __ldg(line + 2), q3 = __ldg(line + 3);
        const uint32_t r[BLOCKED_WORDS] = {q0.x, q0.y, q0.z, q0.w,
                                           q1.x, q1.y, q1.z, q1.w,
                                           q2.x, q2.y, q2.z, q2.w,
                                           q3.x, q3.y, q3.z, q3.w};
        uint32_t m[BLOCKED_WORDS];
        blocked_masks(c, h, km, m);
        bool all = true;
#pragma unroll
        for (int w = 0; w < BLOCKED_WORDS; ++w) all &= (r[w] & m[w]) == m[w];
        hit[i] = all;
    }
}

// canon uint64 [n] canonical hashes; valid bool [n] or null (every k-mer
// valid); rows uint32 [nblocks, 16], 16-byte aligned, updated in place;
// (magic, shift) the Barrett constants of nblocks; km = k * multiSeed.
extern "C" int btl_blocked_insert(const void* canon, const void* valid,
                                  long long n, void* rows, long long nblocks,
                                  unsigned long long magic, int shift, int h,
                                  unsigned long long km, int device,
                                  void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks < 1 || h < 1 || (reinterpret_cast<uintptr_t>(rows) & 15))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    blocked_insert_kernel<<<btl_blocks(4 * n), BTL_BLOCK, 0,
                            (cudaStream_t)stream>>>(
        (const uint64_t*)canon, (const bool*)valid, n,
        (unsigned long long*)rows, (uint64_t)nblocks, magic, shift, h, km);
    return (int)cudaGetLastError();
}

// The fused insert: codes uint8 [B, L] (A=0 C=1 G=2 T=3, >= 4 an N), k >= 1,
// L >= k; every window with no N inserted. run: windows a thread rolls, 16
// or 32 (kernels/nthash_scan.py run_length); tables: the 50 uint64 of
// RollTables for this k. Other arguments as btl_blocked_insert's.
extern "C" int btl_blocked_insert_seq(const void* codes, long long B,
                                      long long L, int k, int run,
                                      const void* tables, void* rows,
                                      long long nblocks,
                                      unsigned long long magic, int shift,
                                      int h, unsigned long long km,
                                      int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long W = L - k + 1;
    if (nblocks < 1 || h < 1 || k < 1 || (run != 16 && run != 32)
        || (reinterpret_cast<uintptr_t>(rows) & 15))
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || W <= 0) return (int)cudaGetLastError();
    const long long tiles = (W + SEQ_TILE - 1) / SEQ_TILE;
    if (B * tiles >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
    RollTables tab;
    memcpy(&tab, tables, sizeof tab);
    auto kernel = run == 16 ? blocked_insert_seq_kernel<16>
                            : blocked_insert_seq_kernel<32>;
    kernel<<<(unsigned)(B * tiles), BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, L, k, W, tiles, tab,
        (unsigned long long*)rows, (uint64_t)nblocks, magic, shift, h, km);
    return (int)cudaGetLastError();
}

// The query: arguments as btl_blocked_insert's, hit bool [n] out (false
// where valid is false).
extern "C" int btl_blocked_contains(const void* canon, const void* valid,
                                    long long n, const void* rows,
                                    long long nblocks,
                                    unsigned long long magic, int shift,
                                    int h, unsigned long long km, void* hit,
                                    int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (nblocks < 1 || h < 1 || (reinterpret_cast<uintptr_t>(rows) & 15))
        return (int)cudaErrorInvalidValue;
    blocked_contains_kernel<<<btl_blocks(n), BTL_BLOCK, 0,
                              (cudaStream_t)stream>>>(
        (const uint64_t*)canon, (const bool*)valid, n,
        (const unsigned int*)rows, (uint64_t)nblocks, magic, shift, h, km,
        (bool*)hit);
    return (int)cudaGetLastError();
}
