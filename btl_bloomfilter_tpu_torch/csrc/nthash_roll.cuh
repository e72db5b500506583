// ntHash's roll, shared by the ntHash kernel (nthash_scan.cu), the
// spaced-seed hash (spaced_scan.cu) and the blocked filter's fused insert
// (blocked_bloom.cu): the roll tables by (out, in) base-code pair, the split
// rotations, the code reader and the roll of one run of windows.
#pragma once

#include <cstdint>

#define CODE_N 4

// The roll's XOR terms by (out, in) code pair, index out * 5 + in.
struct RollTables {
    uint64_t f[25];   // srol^k(seed(out)) ^ seed(in)
    uint64_t r[25];   // sror(rcseed(out)) ^ srol^(k-1)(rcseed(in))
};

// srol and sror: the low 33 and the high 31 bits rotate by one, each on
// its own.
__device__ __forceinline__ uint64_t srol1(uint64_t v) {
    return ((v << 1) & ~(1ULL << 33)) | ((v >> 32) & 1ULL)
           | ((v >> 30) & (1ULL << 33));
}

__device__ __forceinline__ uint64_t sror1(uint64_t v) {
    return ((v >> 1) & ~(1ULL << 32)) | ((v & 1ULL) << 32)
           | ((v & (1ULL << 33)) << 30);
}

// Base codes in order from a byte address, read four to an aligned 32-bit
// load; the next word is loaded only when the bytes are needed, so no load
// reaches past the word that holds the last code read.
struct CodeReader {
    const uint32_t* w;
    uint32_t cur;
    int sh;

    __device__ __forceinline__ explicit CodeReader(const uint8_t* p) {
        const uintptr_t a = (uintptr_t)p;
        w = (const uint32_t*)(a & ~(uintptr_t)3);
        sh = (int)(a & 3) * 8;
        cur = __ldg(w);
    }

    __device__ __forceinline__ int next() {
        if (sh == 32) {
            cur = __ldg(++w);
            sh = 0;
        }
        const uint32_t c = (cur >> sh) & 0xFFu;
        sh += 8;
        return c < 4 ? (int)c : CODE_N;
    }
};

// The run of R windows p .. p + R - 1 of a read (those below W): rolled in
// from the all-N window (hashes 0) with k steps whose out-base is N, then
// one roll step a window. Window p + r's canonical hash goes to out[r *
// stride]; returns 2 bits a window, bit 2r its strand (rh < fh, the
// canonical tie-break) and bit 2r + 1 whether it holds no N. s_f, s_r: the
// RollTables' terms.
template <int R>
__device__ __forceinline__ uint64_t btl_roll_run(const uint8_t* row,
                                                 long long p, long long W,
                                                 int k, const uint64_t* s_f,
                                                 const uint64_t* s_r,
                                                 uint64_t* out, int stride) {
    CodeReader in(row + p);
    uint64_t fh = 0, rh = 0, flags = 0;
    int n_count = 0;
    for (int j = 0; j < k; ++j) {
        const int c = in.next();
        fh = srol1(fh) ^ s_f[CODE_N * 5 + c];
        rh = sror1(rh) ^ s_r[CODE_N * 5 + c];
        n_count += c == CODE_N;
    }
    CodeReader outr(row + p);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (p + r >= W) break;
        const bool st = rh < fh;
        out[r * stride] = st ? rh : fh;
        flags |= (uint64_t)(st | (n_count == 0) << 1) << (2 * r);
        if (r + 1 < R && p + r + 1 < W) {
            const int o = outr.next(), i = in.next();
            fh = srol1(fh) ^ s_f[o * 5 + i];
            rh = sror1(rh) ^ s_r[o * 5 + i];
            n_count += (i == CODE_N) - (o == CODE_N);
        }
    }
    return flags;
}
