// ntHash's roll, shared by the ntHash kernel (nthash_scan.cu) and the
// spaced-seed hash (spaced_scan.cu): the roll tables by (out, in) base-code
// pair and the split rotations.
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
