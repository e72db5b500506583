// Canonical ntHash of every k-mer window of a batch of reads, with the
// h-fold multi-hash derivation, N-window validity and, in positions mode,
// the reduction mod the filter size with the 0xFFFFFFFF sentinel.
//
// Replaces: btl_bloomfilter_tpu/kernels/nthash_scan.py:_kernel (the Pallas
// kernel behind positions_planes_kernel and hash_frames_planes_kernel).
// The TPU kernel walks 128-lane column blocks in order, carrying a prefix-
// XOR from block to block, because the TPU has no 64-bit integers and
// favours long vector scans. CUDA blocks run in no order, so nothing is
// carried here: each thread computes its own window directly,
//
//   fh(p) = XOR_j srol^{k-1-j}(seed(s[p+j])),  rh(p) = XOR_j srol^{j}(rcseed(s[p+j]))
//
// from per-block tables of the pre-rotated seeds (5 codes x k offsets, in
// shared memory), with native uint64_t arithmetic. Any k >= 1: the block
// walks the k offsets in pieces of KPIECE, rebuilding the two tables and
// the code tile for each piece, so shared memory stays at 10,623 bytes
// whatever k is. srol^t has period lcm(33, 31) = 1023 in t, which the
// exponents k - 1 - j and j pass for k > 1023.
//
// What bounds it on the H100: the output. At 512 reads x 2048 bases, k=31,
// h=4, it writes 16 B of positions (or 32 B of hashes) plus 2 B of flags per
// window against 1 B of codes read. The 2k shared-memory table lookups per
// window are the compute side. Design: one block per (read, 256-window
// tile); the tile's codes are staged in shared memory, once for k <= 128;
// thread t writes window t of the tile, so every store of every h-plane is
// coalesced. The mod by a non-power-of-two size is a Barrett multiply
// (magic from the host), a mask for a power of two.

#include "common.cuh"

#define KPIECE 128                   // offsets per table piece
#define NUM_CODES 5

__constant__ uint64_t kSeeds[4] = {
    0x3C8BFBB395C60474ULL,   // A
    0x3193C18562A02B4CULL,   // C
    0x20323ED082572324ULL,   // G
    0x295549F54BE24456ULL,   // T
};
#define MULTI_SEED 0x90B45D39FB6DA1FAULL
#define MULTI_SHIFT 27

// ntHash's split rotation to the power t: the low 33 and the high 31 bits
// rotate independently.
__device__ __forceinline__ uint64_t srol_pow(uint64_t v, unsigned t) {
    const uint64_t mask33 = (1ULL << 33) - 1;
    unsigned t33 = t % 33, t31 = t % 31;
    uint64_t lo = v & mask33, hi = v >> 33;
    if (t33) lo = ((lo << t33) | (lo >> (33 - t33))) & mask33;
    if (t31) hi = ((hi << t31) | (hi >> (31 - t31))) & 0x7FFFFFFFULL;
    return (hi << 33) | lo;
}

// v % size for size < 2**32: a mask when magic == 0 (size a power of two),
// else Barrett: q = mulhi(v, magic) >> shift is floor(v/size) or one less.
__device__ __forceinline__ uint32_t mod_size(uint64_t v, uint64_t size,
                                             uint64_t magic, int shift) {
    if (magic == 0) return (uint32_t)(v & (size - 1));
    uint64_t q = __umul64hi(v, magic) >> shift;
    uint64_t r = v - q * size;
    if (r >= size) r -= size;
    return (uint32_t)r;
}

// PIECES is false for k <= KPIECE: one piece, compiled as a straight line
// so that short k keeps the per-window cost of a kernel with one table.
template <bool PIECES>
__global__ void __launch_bounds__(BTL_BLOCK)
nthash_scan_kernel(const uint8_t* __restrict__ codes, long long B,
                   long long L, int k, int h, long long W,
                   long long tiles_per_row, int positions_mode,
                   uint64_t size, uint64_t magic, int shift,
                   void* __restrict__ out, bool* __restrict__ strand,
                   bool* __restrict__ valid) {
    __shared__ uint64_t tf[KPIECE * NUM_CODES];
    __shared__ uint64_t tr[KPIECE * NUM_CODES];
    __shared__ uint8_t sc[BTL_BLOCK + KPIECE - 1];

    const long long b = blockIdx.x / tiles_per_row;
    const long long p0 = (blockIdx.x % tiles_per_row) * BTL_BLOCK;
    const long long p = p0 + threadIdx.x;
    const uint8_t* row = codes + b * L + p0;

    uint64_t fh = 0, rh = 0;
    int n_count = 0;
    for (int j0 = 0; j0 < (PIECES ? k : 1); j0 += KPIECE) {
        const int kp = !PIECES ? k : k - j0 < KPIECE ? k - j0 : KPIECE;
        if (PIECES && j0) __syncthreads();   // the last piece's tables read
        // tf[j][c] = srol^{k-1-j}(seed c), tr[j][c] = srol^{j}(rcseed c)
        // for the piece's offsets j = j0 + jj; N -> 0
        for (int i = threadIdx.x; i < kp * NUM_CODES; i += blockDim.x) {
            const int j = j0 + i / NUM_CODES, c = i % NUM_CODES;
            tf[i] = c < 4 ? srol_pow(kSeeds[c], (unsigned)(k - 1 - j)) : 0;
            tr[i] = c < 4 ? srol_pow(kSeeds[3 - c], (unsigned)j) : 0;
        }
        long long nload = L - p0 - j0;
        if (nload > BTL_BLOCK + kp - 1) nload = BTL_BLOCK + kp - 1;
        for (int i = threadIdx.x; i < nload; i += blockDim.x) {
            const uint8_t c = row[j0 + i];
            sc[i] = c < 4 ? c : 4;
        }
        __syncthreads();
        if (!PIECES && p >= W) return;
        if (p < W) {
            for (int jj = 0; jj < kp; ++jj) {
                const int c = sc[threadIdx.x + jj];
                fh ^= tf[jj * NUM_CODES + c];
                rh ^= tr[jj * NUM_CODES + c];
                n_count += (c == 4);
            }
        }
    }
    if (p >= W) return;

    const bool st = rh < fh;           // canonical tie-break: rh < fh
    const uint64_t canon = st ? rh : fh;
    const bool ok = n_count == 0;

    const long long plane = B * W;
    const long long idx = b * W + p;
    const uint64_t km = (uint64_t)k * MULTI_SEED;
    for (int i = 0; i < h; ++i) {
        uint64_t v = canon;
        if (i > 0) {
            v = canon * ((uint64_t)i ^ km);
            v ^= v >> MULTI_SHIFT;
        }
        if (positions_mode) {
            ((uint32_t*)out)[i * plane + idx] =
                ok ? mod_size(v, size, magic, shift) : BTL_SENTINEL;
        } else {
            ((uint64_t*)out)[i * plane + idx] = v;
        }
    }
    strand[idx] = st;
    valid[idx] = ok;
}

// codes uint8 [B, L] -> out [h, B, W] (uint32 positions or uint64 hashes),
// strand and valid bool [B, W], W = L - k + 1. Requires k >= 1, L >= k,
// h >= 1; in positions mode 1 <= size < 2**32.
extern "C" int btl_nthash_scan(const void* codes, long long B, long long L,
                               int k, int h, int positions_mode,
                               unsigned long long size,
                               unsigned long long magic, int shift,
                               void* out, void* strand, void* valid,
                               int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    const long long W = L - k + 1;
    const long long tiles = (W + BTL_BLOCK - 1) / BTL_BLOCK;
    if (B <= 0 || W <= 0) return (int)cudaGetLastError();
    auto kernel = k > KPIECE ? nthash_scan_kernel<true>
                             : nthash_scan_kernel<false>;
    kernel<<<(unsigned)(B * tiles), BTL_BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, B, L, k, h, W, tiles, positions_mode,
        (uint64_t)size, (uint64_t)magic, shift, out, (bool*)strand,
        (bool*)valid);
    return (int)cudaGetLastError();
}
