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
// What bounds it on the H100: the keys are read once and written once (8
// bytes a key, 0.0100 ms at 4M keys), but the network runs log2(B)(log2(B)
// + 1)/2 = 66 (B = 2048) or 55 (B = 1024) compare-exchange stages over
// every key. A stage between two registers of a thread is one integer min
// or max a key; a stage across threads is two (each side keeps its own
// half) plus the exchange: a shuffle, or a shared-memory round trip and a
// barrier. The SM's integer pipe (64 a clock) bounds the network, so the
// design moves stages into registers and pays for it with shared-memory
// traffic, which runs on another pipe.
//
// Design: R = 16 keys a thread, held in registers (consecutive keys;
// 16-byte loads and stores, streamed evict-first), so a block is B / 16
// threads. In the home layout index bits 0-3 lie in a thread's registers,
// 4-8 in its lane, the rest in its warp. Every compare-exchange after the
// thread-local sort is ascending: at the start of merge step m (runs of
// 2**m keys) a thread whose run sorts descending holds its keys
// complemented (x ^ 0xFFFFFFFF reverses unsigned order), one XOR a key a
// merge step instead of a select a key a stage. A merge step takes its
// index bits from the top down:
//   * warp bits (9 and up): store the keys to shared memory (16-byte
//     vectors, swizzled so that the eight lanes of a memory phase hit
//     eight bank groups), one barrier (two buffers, so one a stage), load
//     the partner thread's keys;
//   * lane bits 5-8, when a merge step has two or more: one transpose
//     inside the warp through shared memory (16-byte stores, 4-byte loads,
//     no bank conflict, __syncwarp only) swaps them with the register bits,
//     their stages run in registers, and a second transpose brings the
//     home layout back; with fewer, and for lane bit 4, a warp shuffle;
//   * register bits 0-3: min / max in registers.
// At B = 2048 (128 threads): 55 stages in registers, 8 shuffle stages, 3
// through shared memory and 10 transposes; at B = 1024 (64 threads): 47,
// 7, 1 and 8. Measured and not kept (PERF.md): 8 or 32 keys a thread, and
// every lane stage a shuffle (no transposes).

#include "common.cuh"

#define BTL_FULL_MASK 0xFFFFFFFFu

__host__ __device__ constexpr int btl_log2(int v) {
    return v <= 1 ? 0 : 1 + btl_log2(v >> 1);
}

// Compare-exchange of two registers: a takes the smaller key when up.
__device__ __forceinline__ void btl_cx(uint32_t& a, uint32_t& b, bool up) {
    const uint32_t lo = min(a, b), hi = max(a, b);
    a = up ? lo : hi;
    b = up ? hi : lo;
}

// One key of a cross-thread stage: the lower index of the pair keeps the
// smaller key.
__device__ __forceinline__ uint32_t btl_keep(uint32_t x, uint32_t p,
                                             bool lower) {
    return lower ? min(x, p) : max(x, p);
}

// A stage between the thread's registers r and r | j, ascending.
template <int R>
__device__ __forceinline__ void btl_reg_stage(uint32_t (&x)[R], int j) {
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (!(r & j)) btl_cx(x[r], x[r | j], true);
}

// A stage between lanes dl apart.
template <int R>
__device__ __forceinline__ void btl_shfl_stage(uint32_t (&x)[R], int dl,
                                               int lane) {
    const bool lower = !(lane & dl);
#pragma unroll
    for (int r = 0; r < R; ++r)
        x[r] = btl_keep(x[r], __shfl_xor_sync(BTL_FULL_MASK, x[r], dl),
                        lower);
}

// Keys a thread.
constexpr int BTL_SORT_KEYS = 16;
// The fewest stages a pair of warp transposes must bring into registers
// (below it the lane bits go through shuffles).
constexpr int BTL_SORT_MIN_SWAP = 2;

// VEC: in and out are 16-byte aligned (16-byte loads and stores).
template <int BLOCK, bool VEC>
__global__ void __launch_bounds__(BLOCK / BTL_SORT_KEYS)
block_sort_kernel(const uint32_t* __restrict__ in,
                  uint32_t* __restrict__ out) {
    constexpr int R = BTL_SORT_KEYS, NT = BLOCK / R;
    constexpr int LR = btl_log2(R), LB = btl_log2(BLOCK);
    constexpr int Q = R / 4;                // 16-byte vectors a thread
    constexpr int LO = 5 - LR;              // lane bits that stay lane bits
    // vector c of lane u sits at u * Q + (c ^ swizzle(u)), swizzle(u) =
    // (u >> LO) & SWZ: the eight lanes of a 16-byte memory phase hit eight
    // bank groups
    constexpr int SWZ = Q - 1;
    static_assert(R >= 8 && R <= 32 && (R & (R - 1)) == 0, "R 8, 16, 32");
    static_assert(NT >= 32 && NT % 32 == 0, "whole warps");
    // two buffers of the block's keys for the cross-warp stages, and each
    // warp's own for its transposes
    __shared__ uint4 s[2][BLOCK / 4];
    __shared__ uint4 tw[BLOCK / 4];
    const int t = threadIdx.x, lane = t & 31;
    const int swz = (t >> LO) & SWZ;
    uint4* tv = tw + (t >> 5) * 8 * R;      // this warp's 32 R keys
    uint32_t* ts = reinterpret_cast<uint32_t*>(tv);
    // in the transposed layout register r of this lane is word tbase[r &
    // SWZ] + 32 r of the warp's keys
    int tbase[SWZ + 1];
#pragma unroll
    for (int k = 0; k <= SWZ; ++k)
        tbase[k] = (lane & ((1 << LO) - 1)) * R
                   + 4 * ((lane >> (LO + 2)) ^ k) + ((lane >> LO) & 3);
    const long long base = (long long)blockIdx.x * BLOCK + (long long)t * R;

    uint32_t x[R];
    if (VEC) {
        const uint4* p = reinterpret_cast<const uint4*>(in + base);
#pragma unroll
        for (int c = 0; c < Q; ++c) {
            const uint4 v = __ldcs(p + c);
            x[4 * c] = v.x;
            x[4 * c + 1] = v.y;
            x[4 * c + 2] = v.z;
            x[4 * c + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] = in[base + r];
    }

    // merge steps 1 .. LR - 1: runs inside the thread, directions known
#pragma unroll
    for (int m = 1; m < LR; ++m)
#pragma unroll
        for (int j = 1 << (m - 1); j > 0; j >>= 1)
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (!(r & j)) btl_cx(x[r], x[r | j], !((r >> m) & 1));

    // merge steps LR .. LB: a descending run's keys held complemented
    uint32_t flip = 0;
    int buf = 0;
#pragma unroll
    for (int m = LR; m <= LB; ++m) {
        const uint32_t f = m < LB ? 0u - ((t >> (m - LR)) & 1u) : 0u;
        const uint32_t d = f ^ flip;
        flip = f;
#pragma unroll
        for (int r = 0; r < R; ++r) x[r] ^= d;
        // index bits m - 1 .. LR + 5: the partner in another warp
#pragma unroll
        for (int b = m - 1; b >= LR + 5; --b) {
            const int dt = 1 << (b - LR), u = t ^ dt;
            const bool lower = !(t & dt);
            uint4* sb = s[buf];
#pragma unroll
            for (int c = 0; c < Q; ++c)
                sb[t * Q + (c ^ swz)] = make_uint4(
                    x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
            __syncthreads();
#pragma unroll
            for (int c = 0; c < Q; ++c) {
                const uint4 v = sb[u * Q + (c ^ swz)];
                x[4 * c] = btl_keep(x[4 * c], v.x, lower);
                x[4 * c + 1] = btl_keep(x[4 * c + 1], v.y, lower);
                x[4 * c + 2] = btl_keep(x[4 * c + 2], v.z, lower);
                x[4 * c + 3] = btl_keep(x[4 * c + 3], v.w, lower);
            }
            buf ^= 1;
        }
        // bits top .. LR: the partner in this warp. Bits 5 .. LR + 4 can
        // come into the registers by a transpose inside the warp (index
        // bit 5 + q to register bit q, the thread's register bits to the
        // top lane bits), so that their stages run in registers
        const int top = m - 1 < LR + 4 ? m - 1 : LR + 4;
        if (top - 4 >= BTL_SORT_MIN_SWAP) {
#pragma unroll
            for (int c = 0; c < Q; ++c)
                tv[lane * Q + (c ^ swz)] = make_uint4(
                    x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
            __syncwarp();
#pragma unroll
            for (int r = 0; r < R; ++r) x[r] = ts[tbase[r & SWZ] + 32 * r];
#pragma unroll
            for (int b = top; b >= 5; --b) btl_reg_stage(x, 1 << (b - 5));
#pragma unroll
            for (int b = top < 4 ? top : 4; b >= LR; --b)
                btl_shfl_stage(x, 1 << (b - LR), lane);
            __syncwarp();
#pragma unroll
            for (int r = 0; r < R; ++r) ts[tbase[r & SWZ] + 32 * r] = x[r];
            __syncwarp();
#pragma unroll
            for (int c = 0; c < Q; ++c) {
                const uint4 v = tv[lane * Q + (c ^ swz)];
                x[4 * c] = v.x;
                x[4 * c + 1] = v.y;
                x[4 * c + 2] = v.z;
                x[4 * c + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int b = top; b >= LR; --b)
                btl_shfl_stage(x, 1 << (b - LR), lane);
        }
        // bits LR - 1 .. 0: the partner in this thread
#pragma unroll
        for (int b = m - 1 < LR - 1 ? m - 1 : LR - 1; b >= 0; --b)
            btl_reg_stage(x, 1 << b);
    }

    if (VEC) {
        uint4* p = reinterpret_cast<uint4*>(out + base);
#pragma unroll
        for (int c = 0; c < Q; ++c)
            __stcs(p + c, make_uint4(x[4 * c], x[4 * c + 1], x[4 * c + 2],
                                     x[4 * c + 3]));
    } else {
#pragma unroll
        for (int r = 0; r < R; ++r) out[base + r] = x[r];
    }
}

template <int BLOCK>
static cudaError_t btl_block_sort_launch(const void* in, void* out,
                                         long long nblocks, cudaStream_t st) {
    constexpr int NT = BLOCK / BTL_SORT_KEYS;
    const uint32_t* src = (const uint32_t*)in;
    uint32_t* dst = (uint32_t*)out;
    if (((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out))
         & 15) == 0)
        block_sort_kernel<BLOCK, true>
            <<<(unsigned)nblocks, NT, 0, st>>>(src, dst);
    else
        block_sort_kernel<BLOCK, false>
            <<<(unsigned)nblocks, NT, 0, st>>>(src, dst);
    return cudaGetLastError();
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
        return (int)btl_block_sort_launch<1024>(in, out, nblocks, st);
    case 2048:
        return (int)btl_block_sort_launch<2048>(in, out, nblocks, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
