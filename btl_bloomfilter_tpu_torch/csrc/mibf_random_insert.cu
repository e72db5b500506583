// The MIBF's random-order, strand-carrying insert (MIBloomFilter::insert,
// MIBloomFilter.hpp:312-438): frame after frame, each of its h slots takes
// the frame's ID (with the strand bit where the slot's strand differs from
// the insert's direction) in an order that std::shuffle, driven by a
// std::minstd_rand seeded with the ID XOR the frame's hashes, makes; a slot
// is never overwritten, and a frame that could place its ID nowhere and is
// not saturated saturates all its slots.
//
// Replaces: btl_bloomfilter_tpu/models/mibf_construct.py:
// insert_random_order_device, a lax.scan over frames (:1213) with no
// Pallas twin, itself held against the host mirror insert_random_order.
//
// Design, simple and right first: two kernels from one entry point.
//  1. One thread a slot, in parallel: position = hash % size (uint64) and
//     its rank through the rank directory of models/mibf.py freeze (one
//     32-byte block a 7 words: the block's cumulative count, then its
//     words), into a scratch array of ranks. Ranks depend only on the
//     frozen bit vector.
//  2. One thread walks the frames in order, since a frame reads what the
//     frames before it wrote. Phase A counts the slots that already hold
//     the frame's value (saturation bit stripped), collects the others and
//     XORs each live hash into the seed; phase B seeds minstd_rand with
//     (ID ^ hashes) mod 2147483647 (0 -> 1), shuffles the collected slots
//     with libstdc++'s std::shuffle (two bounded ints a draw from its
//     rejection-sampling uniform_int_distribution) and inserts in that
//     order into empty entries until max_count agree; then the saturation
//     fallback. Where the reference asserts (a frame that placed nothing
//     at max_count > 1), this saturates, as the JAX device form does.
//     Reads of a rank past the ID array clamp to its last entry and writes
//     there are dropped, as an XLA gather and scatter do.
//
// What bounds it on the H100: the walk's chain of dependent loads and
// stores on one thread, a few hundred ns a frame; the bytes (hashes,
// strands, the entries touched) take a thousandth of that. A design that
// runs frames in parallel (independent frames, a conflict replay) is a
// later PR's.

#include "common.cuh"

#define MINSTD_MULT 48271ULL
#define MINSTD_MOD 2147483647ULL
// the engine's range, max - min
#define URNG_RANGE 2147483645U
// slots a frame, at most (the walk keeps a frame's order in shared memory)
#define RI_MAX_H 4096

__global__ void __launch_bounds__(BTL_BLOCK)
ri_rank_kernel(const uint64_t* __restrict__ hashes, long long n,
               uint64_t size, const uint4* __restrict__ dir, uint32_t nwords,
               uint32_t* __restrict__ ranks) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const uint32_t p = (uint32_t)(hashes[i] % size);
        const uint32_t w = min(p >> 5, nwords - 1u);
        const uint32_t b = w / 7u, j = w - 7u * b;
        const uint4 lo = __ldg(&dir[2 * (size_t)b]);
        const uint4 hi = __ldg(&dir[2 * (size_t)b + 1]);
        const uint32_t v[7] = {lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t r = lo.x, word = 0;
#pragma unroll
        for (uint32_t k = 0; k < 7; ++k) {
            if (k < j) r += __popc(v[k]);
            if (k == j) word = v[k];
        }
        ranks[i] = r + __popc(word & ((1u << (p & 31u)) - 1u));
    }
}

struct Minstd {
    uint32_t x;

    __device__ __forceinline__ uint32_t next() {
        x = (uint32_t)(((uint64_t)x * MINSTD_MULT) % MINSTD_MOD);
        return x;
    }

    // libstdc++ uniform_int_distribution over [0, b]: downscale, reject
    __device__ __forceinline__ uint32_t uniform(uint32_t b) {
        const uint32_t uerange = b + 1u;
        const uint32_t scaling = URNG_RANGE / uerange;
        const uint32_t past = uerange * scaling;
        uint32_t ret;
        do {
            ret = next() - 1u;
        } while (ret >= past);
        return ret / scaling;
    }
};

template <typename T>
__global__ void ri_walk_kernel(const uint64_t* __restrict__ hashes,
                               const uint32_t* __restrict__ ranks,
                               const bool* __restrict__ strand,
                               const bool* __restrict__ valid, long long n,
                               int h, T* __restrict__ data, long long d_size,
                               uint64_t id_value, int max_count,
                               bool* __restrict__ success) {
    extern __shared__ int order[];   // h slots
    const T smask = (T)1 << (8 * sizeof(T) - 1);
    const T anti = smask - 1;
    const T sstrand = (T)1 << (8 * sizeof(T) - 2);
    const T idv = (T)id_value;
    const bool strand_dir = max_count % 2;
    for (long long f = 0; f < n; ++f) {
        if (valid != nullptr && !valid[f]) {
            success[f] = false;
            continue;
        }
        const long long base = f * h;
        // the value of slot i: the ID, with the strand bit where the slot's
        // strand differs from the insert's direction
        auto value = [&](int i) -> T {
            return (strand != nullptr && (strand_dir ^ strand[base + i]))
                       ? (T)(idv | sstrand) : idv;
        };
        // phase A: slots that already agree; the others, in slot order
        int count = 0, nord = 0;
        bool saturated = true, done = false;
        uint64_t seed = id_value;
        for (int i = 0; i < h; ++i) {
            const T old = data[min((long long)ranks[base + i], d_size - 1)];
            const T oldv = old > smask ? (T)(old & anti) : old;
            if (old <= smask) saturated = false;
            if (oldv == value(i)) ++count; else order[nord++] = i;
            if (count >= max_count) {
                done = true;
                break;
            }
            seed ^= hashes[base + i];
        }
        if (done) {
            success[f] = true;
            continue;
        }
        // phase B: std::shuffle of the collected slots, then insert
        Minstd g;
        g.x = (uint32_t)(seed % MINSTD_MOD);
        if (g.x == 0) g.x = 1;
        if (nord > 1) {
            int i = 1;
            if (nord % 2 == 0) {
                const int j = (int)g.uniform(1);
                const int t = order[1]; order[1] = order[j]; order[j] = t;
                i = 2;
            }
            while (i < nord) {
                const uint32_t b1 = (uint32_t)i + 2u;
                const uint32_t x = g.uniform(((uint32_t)i + 1u) * b1 - 1u);
                const int p0 = (int)(x / b1), p1 = (int)(x % b1);
                int t = order[i]; order[i] = order[p0]; order[p0] = t;
                if (++i == nord) break;
                t = order[i]; order[i] = order[p1]; order[p1] = t;
                ++i;
            }
        }
        for (int j = 0; j < nord && !done; ++j) {
            const int i = order[j];
            const long long r = ranks[base + i];
            const T old = data[min(r, d_size - 1)];
            if (old == 0) {
                if (r < d_size) data[r] = value(i);
                ++count;
            }
            if (old <= smask) saturated = false;
            done = count >= max_count;
        }
        if (count == 0 && !saturated) {
            // the saturation fallback, on every slot of the frame
            for (int i = 0; i < h; ++i) {
                const long long r = ranks[base + i];
                if (r < d_size) data[r] |= smask;
            }
        }
        success[f] = count > 0;
    }
}

template <typename T>
static cudaError_t walk(const void* hashes, const void* ranks,
                        const void* strand, const void* valid, long long n,
                        int h, void* data, long long d_size,
                        unsigned long long id_value, int max_count,
                        void* success, cudaStream_t stream) {
    ri_walk_kernel<T><<<1, 1, h * sizeof(int), stream>>>(
        (const uint64_t*)hashes, (const uint32_t*)ranks, (const bool*)strand,
        (const bool*)valid, n, h, (T*)data, d_size, id_value, max_count,
        (bool*)success);
    return cudaGetLastError();
}

// hashes uint64 [n, h] (1 <= h <= RI_MAX_H); size the bit vector's length
// in bits (< 2**32); dir its rank directory (nwords words, 16-byte
// aligned); data the ID array [d_size >= 1] of `width` bytes (1, 2 or 4),
// updated in place; strand bool [n, h] and valid bool [n], each null for
// none; ranks uint32 [n * h] scratch; success bool [n].
extern "C" int btl_mibf_random_insert(const void* hashes, long long n, int h,
                                      unsigned long long size,
                                      const void* dir, long long nwords,
                                      void* data, int width,
                                      long long d_size,
                                      unsigned long long id_value,
                                      int max_count, const void* strand,
                                      const void* valid, void* ranks,
                                      void* success, int device,
                                      void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (h < 1 || h > RI_MAX_H || size < 1 || size > (1ULL << 32) ||
        nwords < 1 || nwords > (1LL << 27) || d_size < 1 ||
        (reinterpret_cast<uintptr_t>(dir) & 15))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    ri_rank_kernel<<<btl_blocks(n * h), BTL_BLOCK, 0, s>>>(
        (const uint64_t*)hashes, n * h, (uint64_t)size, (const uint4*)dir,
        (uint32_t)nwords, (uint32_t*)ranks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (width) {
        case 1:
            return (int)walk<uint8_t>(hashes, ranks, strand, valid, n, h,
                                      data, d_size, id_value, max_count,
                                      success, s);
        case 2:
            return (int)walk<uint16_t>(hashes, ranks, strand, valid, n, h,
                                       data, d_size, id_value, max_count,
                                       success, s);
        case 4:
            return (int)walk<uint32_t>(hashes, ranks, strand, valid, n, h,
                                       data, d_size, id_value, max_count,
                                       success, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
