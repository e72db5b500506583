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
// The frame routine (insert_frame): phase A counts the slots that already
// hold the frame's value (saturation bit stripped), collects the others and
// XORs each live hash into the seed; phase B seeds minstd_rand with (ID ^
// hashes) mod 2147483647 (0 -> 1), shuffles the collected slots with
// libstdc++'s std::shuffle (two bounded ints a draw from its
// rejection-sampling uniform_int_distribution) and inserts in that order
// into empty entries until max_count agree; then the saturation fallback.
// Where the reference asserts (a frame that placed nothing at max_count >
// 1), this saturates, as the JAX device form does. Reads of a rank past the
// ID array clamp to its last entry and writes there are dropped, as an XLA
// gather and scatter do.
//
// Design: a frame touches only the ID entries at its slots' keys, key =
// min(rank, d_size - 1), so two frames depend on each other only through a
// shared key, and along each key only the order of the frames matters.
//  1. One thread a slot: its rank through the rank directory of
//     models/mibf.py freeze (one 32-byte block a 7 words: the block's
//     cumulative count, then its words).
//  2. One cooperative launch of the resident grid, one thread a frame:
//     each valid frame enters its keys into an open-addressing table sized
//     to the slots (the next power of two >= 2 n h entries; CAS on the
//     key). Then rounds: every frame still to do tags each of its keys'
//     owners with atomicMax of (round, ~frame), so a key's owner is the
//     lowest such frame; a grid barrier; every frame that owns all its
//     keys (it is ready) runs the frame routine, since no other ready frame
//     shares an entry with it and every lower frame on its keys is done; a
//     grid barrier. Invalid frames take no part.
//  3. When a round readies fewer than 1/RI_MIN_SHARE of the frames left,
//     or after RI_MAX_ROUNDS rounds, the frames left are compacted in index
//     order and one thread walks them (the tail). A frame done in a round
//     shares no key with a lower frame still left, so the walk is exact
//     too. The plain round_schedule in kernels/mibf_random_insert.py makes
//     the same decisions; the launch reports (rounds, frames run in rounds,
//     tail length).
//
// What bounds it on the H100: a round costs one frame routine's chain of
// dependent loads (a few us) and two grid barriers, so a batch whose key
// chains are short (duplicate frames a few deep) takes a few rounds; the
// tail walks at the one-thread rate of the first design, a few hundred ns
// to a few us a frame, which a chain as long as the batch (every frame one
// k-mer) cannot avoid. The bytes (hashes, strands, the entries touched)
// take a small share of either.

#include "common.cuh"

#define MINSTD_MULT 48271ULL
#define MINSTD_MOD 2147483647ULL
// the engine's range, max - min
#define URNG_RANGE 2147483645U
// slots a frame, at most
#define RI_MAX_H 4096
// the rounds: at most RI_MAX_ROUNDS, each readying at least 1/RI_MIN_SHARE
// of the frames left (else the rest goes to the tail)
#define RI_MAX_ROUNDS 64
#define RI_MIN_SHARE 64
// blocks of the cooperative launch, at most (the compaction's counts)
#define RI_MAX_GRID 4096
// an empty key of the owner table; keys stop one below it
#define RI_EMPTY 0xFFFFFFFFu
// counters: the grid barrier, then frames readied and frames left a round
#define RI_CTRS (1 + 2 * RI_MAX_ROUNDS)

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

// The frames and the ID array.
struct Frames {
    const uint64_t* hashes;   // [n, h]
    const uint32_t* ranks;    // [n, h]
    const bool* strand;       // [n, h] or null
    const bool* valid;        // [n] or null
    long long n;
    int h;
    void* data;               // [d_size] of 1, 2 or 4 bytes
    long long d_size;
    uint64_t id_value;
    int max_count;
    bool* success;            // [n]
    int* order;               // [n, h] scratch: each frame's shuffle order
};

// The schedule's working space.
struct Schedule {
    uint32_t* ent;                  // [n, h] each slot's owner-table entry
    uint32_t* tkey;                 // [tmask + 1] keys, RI_EMPTY if free
    unsigned long long* towner;     // [tmask + 1] (round + 1, ~frame)
    uint32_t tmask;
    unsigned char* done;            // [n]
    int* list;                      // [n] the tail's frames in order
    int* bcount;                    // [gridDim.x] frames left a block
    unsigned int* ctr;              // [RI_CTRS]
    int* stats;                     // [3] or null
};

// MIBloomFilter::insert of frame f, the first design's walk body.
template <typename T>
__device__ void insert_frame(const Frames& a, long long f) {
    T* data = (T*)a.data;
    const T smask = (T)1 << (8 * sizeof(T) - 1);
    const T anti = smask - 1;
    const T sstrand = (T)1 << (8 * sizeof(T) - 2);
    const T idv = (T)a.id_value;
    const bool strand_dir = a.max_count % 2;
    const int h = a.h;
    const long long base = f * h;
    int* order = a.order + base;
    const uint32_t* ranks = a.ranks + base;
    // the value of slot i: the ID, with the strand bit where the slot's
    // strand differs from the insert's direction
    auto value = [&](int i) -> T {
        return (a.strand != nullptr && (strand_dir ^ a.strand[base + i]))
                   ? (T)(idv | sstrand) : idv;
    };
    // phase A: slots that already agree; the others, in slot order
    int count = 0, nord = 0;
    bool saturated = true;
    uint64_t seed = a.id_value;
    for (int i = 0; i < h; ++i) {
        const T old = data[min((long long)ranks[i], a.d_size - 1)];
        const T oldv = old > smask ? (T)(old & anti) : old;
        if (old <= smask) saturated = false;
        if (oldv == value(i)) ++count; else order[nord++] = i;
        if (count >= a.max_count) {
            a.success[f] = true;
            return;
        }
        seed ^= a.hashes[base + i];
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
    bool done = false;
    for (int j = 0; j < nord && !done; ++j) {
        const int i = order[j];
        const long long r = ranks[i];
        const T old = data[min(r, a.d_size - 1)];
        if (old == 0) {
            if (r < a.d_size) data[r] = value(i);
            ++count;
        }
        if (old <= smask) saturated = false;
        done = count >= a.max_count;
    }
    if (count == 0 && !saturated) {
        // the saturation fallback, on every slot of the frame
        for (int i = 0; i < h; ++i) {
            const long long r = ranks[i];
            if (r < a.d_size) data[r] |= smask;
        }
    }
    a.success[f] = count > 0;
}

// A barrier of the whole (co-resident) grid, as cooperative groups' grid
// sync: block 0 adds 2**31 - (blocks - 1), every other block 1, so the top
// bit flips once every block has arrived; the fences order each block's
// writes before its arrival and the reads after the flip.
__device__ __forceinline__ void grid_sync(unsigned int* arrived) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int nb =
            blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
        __threadfence();
        const unsigned int old = atomicAdd(arrived, nb);
        while (((old ^ *(volatile unsigned int*)arrived) & 0x80000000u) == 0) {
        }
        __threadfence();
    }
    __syncthreads();
}

// The block's sum of v (every thread calls it).
__device__ __forceinline__ unsigned long long block_sum(
        unsigned long long v, unsigned long long* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < BTL_BLOCK / 32; ++w) v += sh[w];
        sh[0] = v;
    }
    __syncthreads();
    v = sh[0];
    __syncthreads();
    return v;
}

__device__ __forceinline__ uint32_t table_slot(uint32_t key) {
    return (uint32_t)(((uint64_t)key * 0x9E3779B97F4A7C15ULL) >> 32);
}

template <typename T>
__global__ void __launch_bounds__(BTL_BLOCK)
ri_round_kernel(Frames a, Schedule s) {
    __shared__ unsigned long long sh[BTL_BLOCK / 32];
    const long long n = a.n;
    const int h = a.h;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const uint32_t kmax =
        (uint32_t)min(a.d_size - 1, (long long)RI_EMPTY - 1);

    // each valid frame's keys into the owner table
    for (long long f = t0; f < n; f += stride) {
        const bool ok = a.valid == nullptr || a.valid[f];
        s.done[f] = !ok;
        if (!ok) {
            a.success[f] = false;
            continue;
        }
        for (int i = 0; i < h; ++i) {
            const uint32_t key = min(a.ranks[f * h + i], kmax);
            uint32_t e = table_slot(key) & s.tmask;
            while (true) {
                const uint32_t prev = atomicCAS(&s.tkey[e], RI_EMPTY, key);
                if (prev == RI_EMPTY || prev == key) break;
                e = (e + 1) & s.tmask;
            }
            s.ent[f * h + i] = e;
        }
    }

    int round = 0;
    unsigned int ready = 0, left = 0;
    unsigned long long in_rounds = 0;
    for (;; ++round) {
        // each key's owner: the lowest frame still to do that touches it
        const unsigned long long tag = (unsigned long long)(round + 1) << 32;
        for (long long f = t0; f < n; f += stride) {
            if (s.done[f]) continue;
            for (int i = 0; i < h; ++i)
                atomicMax(&s.towner[s.ent[f * h + i]],
                          tag | (0xFFFFFFFFu - (uint32_t)f));
        }
        grid_sync(s.ctr);
        // the frames that own all their keys run
        unsigned long long nready = 0, nleft = 0;
        for (long long f = t0; f < n; f += stride) {
            if (s.done[f]) continue;
            const unsigned long long mine = tag | (0xFFFFFFFFu - (uint32_t)f);
            bool own = true;
            for (int i = 0; i < h && own; ++i)
                own = __ldcg(&s.towner[s.ent[f * h + i]]) == mine;
            if (own) {
                insert_frame<T>(a, f);
                s.done[f] = 1;
                ++nready;
            } else {
                ++nleft;
            }
        }
        nready = block_sum(nready, sh);
        nleft = block_sum(nleft, sh);
        if (threadIdx.x == 0) {
            atomicAdd(&s.ctr[1 + round], (unsigned int)nready);
            atomicAdd(&s.ctr[1 + RI_MAX_ROUNDS + round], (unsigned int)nleft);
        }
        grid_sync(s.ctr);
        ready = *(volatile unsigned int*)&s.ctr[1 + round];
        left = *(volatile unsigned int*)&s.ctr[1 + RI_MAX_ROUNDS + round];
        in_rounds += ready;
        if (left == 0 || round + 1 == RI_MAX_ROUNDS ||
            (unsigned long long)ready * RI_MIN_SHARE < ready + left)
            break;
    }

    if (left) {
        // the tail: the frames left into list, in index order (block b
        // takes the b-th contiguous chunk of frames), then one thread
        // walks them
        const long long chunk = (n + gridDim.x - 1) / gridDim.x;
        const long long c0 = min(n, (long long)blockIdx.x * chunk);
        const long long c1 = min(n, c0 + chunk);
        unsigned long long cnt = 0;
        for (long long f = c0 + threadIdx.x; f < c1; f += blockDim.x)
            cnt += __ldcg(&s.done[f]) == 0;
        cnt = block_sum(cnt, sh);
        if (threadIdx.x == 0) s.bcount[blockIdx.x] = (int)cnt;
        grid_sync(s.ctr);
        unsigned long long off = 0;
        for (int b = threadIdx.x; b < (int)blockIdx.x; b += blockDim.x)
            off += __ldcg(&s.bcount[b]);
        off = block_sum(off, sh);
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        for (long long p = c0; p < c1; p += blockDim.x) {
            const long long f = p + threadIdx.x;
            const bool keep = f < c1 && __ldcg(&s.done[f]) == 0;
            const unsigned int bal = __ballot_sync(0xFFFFFFFFu, keep);
            if (lane == 0) sh[warp] = __popc(bal);
            __syncthreads();
            unsigned long long before = 0, total = 0;
            for (int w = 0; w < BTL_BLOCK / 32; ++w) {
                if (w < warp) before += sh[w];
                total += sh[w];
            }
            if (keep)
                s.list[off + before + __popc(bal & ((1u << lane) - 1u))] =
                    (int)f;
            off += total;
            __syncthreads();
        }
        grid_sync(s.ctr);
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            int next = __ldcg(&s.list[0]);
            for (unsigned int j = 0; j < left; ++j) {
                const int f = next;
                if (j + 1 < left) next = __ldcg(&s.list[j + 1]);
                insert_frame<T>(a, f);
            }
        }
    }
    if (s.stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        s.stats[0] = round + (ready > 0);
        s.stats[1] = (int)in_rounds;
        s.stats[2] = (int)left;
    }
}

static unsigned long long table_entries(long long slots) {
    unsigned long long t = 64;
    while (t < 2ULL * (unsigned long long)slots) t <<= 1;
    return t;
}

static size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Bytes of the scratch btl_mibf_random_insert takes for n frames of h
// slots: the owner table's owners, the counters, its keys, then per slot
// the rank, the table entry and the shuffle order, per frame the tail list
// and the done flag, and the compaction's block counts.
extern "C" long long btl_mibf_random_insert_scratch(long long n, int h) {
    const unsigned long long t = table_entries(n * h);
    return (long long)(align16(8 * t) + align16(4 * RI_CTRS) +
                       align16(4 * t) + 3 * align16(4 * (size_t)(n * h)) +
                       align16(4 * (size_t)n) + align16((size_t)n) +
                       4 * RI_MAX_GRID);
}

template <typename T>
static cudaError_t run_rounds(Frames a, Schedule s, int device,
                              cudaStream_t stream) {
    auto kernel = ri_round_kernel<T>;
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, BTL_BLOCK, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    long long grid = (long long)per_sm * sms;
    const long long need = (a.n + BTL_BLOCK - 1) / BTL_BLOCK;
    if (grid > need) grid = need;
    if (grid > RI_MAX_GRID) grid = RI_MAX_GRID;
    if (grid < 1) return cudaErrorLaunchOutOfResources;
    void* args[] = {&a, &s};
    return cudaLaunchCooperativeKernel((const void*)kernel,
                                       dim3((unsigned)grid), dim3(BTL_BLOCK),
                                       args, 0, stream);
}

// hashes uint64 [n, h] (1 <= h <= RI_MAX_H, n < 2**31, n h <= 2**30);
// size the bit vector's length in bits (<= 2**32); dir its rank directory
// (nwords words, 16-byte aligned); data the ID array [d_size >= 1] of
// `width` bytes (1, 2 or 4), updated in place; strand bool [n, h] and
// valid bool [n], each null for none; scratch of
// btl_mibf_random_insert_scratch(n, h) bytes, 16-byte aligned; stats int32
// [3] (rounds that ran frames, frames run in rounds, frames of the tail)
// or null; success bool [n].
extern "C" int btl_mibf_random_insert(const void* hashes, long long n, int h,
                                      unsigned long long size,
                                      const void* dir, long long nwords,
                                      void* data, int width,
                                      long long d_size,
                                      unsigned long long id_value,
                                      int max_count, const void* strand,
                                      const void* valid, void* scratch,
                                      void* stats, void* success, int device,
                                      void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (h < 1 || h > RI_MAX_H || size < 1 || size > (1ULL << 32) ||
        nwords < 1 || nwords > (1LL << 27) || d_size < 1 ||
        n >= (1LL << 31) || n * h > (1LL << 30) ||
        (reinterpret_cast<uintptr_t>(dir) & 15) ||
        (reinterpret_cast<uintptr_t>(scratch) & 15))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned long long t = table_entries(n * h);
    char* p = (char*)scratch;
    Schedule s;
    s.towner = (unsigned long long*)p;
    s.ctr = (unsigned int*)(p + align16(8 * t));
    const size_t zeroed = align16(8 * t) + align16(4 * RI_CTRS);
    p += zeroed;
    s.tkey = (uint32_t*)p;
    p += align16(4 * t);
    uint32_t* ranks = (uint32_t*)p;
    p += align16(4 * (size_t)(n * h));
    s.ent = (uint32_t*)p;
    p += align16(4 * (size_t)(n * h));
    int* order = (int*)p;
    p += align16(4 * (size_t)(n * h));
    s.list = (int*)p;
    p += align16(4 * (size_t)n);
    s.done = (unsigned char*)p;
    p += align16((size_t)n);
    s.bcount = (int*)p;
    s.tmask = (uint32_t)(t - 1);
    s.stats = (int*)stats;
    err = cudaMemsetAsync(scratch, 0, zeroed, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(s.tkey, 0xFF, 4 * t, st);
    if (err != cudaSuccess) return (int)err;
    ri_rank_kernel<<<btl_blocks(n * h), BTL_BLOCK, 0, st>>>(
        (const uint64_t*)hashes, n * h, (uint64_t)size, (const uint4*)dir,
        (uint32_t)nwords, ranks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Frames a = {(const uint64_t*)hashes, ranks, (const bool*)strand,
                      (const bool*)valid, n, h, data, d_size, id_value,
                      max_count, (bool*)success, order};
    switch (width) {
        case 1: return (int)run_rounds<uint8_t>(a, s, device, st);
        case 2: return (int)run_rounds<uint16_t>(a, s, device, st);
        case 4: return (int)run_rounds<uint32_t>(a, s, device, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
