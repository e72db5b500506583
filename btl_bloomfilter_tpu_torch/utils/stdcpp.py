"""Host mirrors of the libstdc++ primitives the MIBF insert order depends on
(a copy of the reference's ``utils/stdcpp.py``).

MIBloomFilter<T>::insert orders a frame's slots with ``std::shuffle``
driven by a ``std::minstd_rand`` seeded with ``id ^ XOR(hashes)``
(MIBloomFilter.hpp:343-344, 409-410), and MIBFConstructSupport's reservoir
sampling uses ``std::hash<T>``, the identity for integral T in libstdc++
(MIBFConstructSupport.hpp:125). The mirror keeps libstdc++'s exact draws:
the rejection-sampling ``uniform_int_distribution`` and the shuffle that
takes two bounded ints from one draw. ``tests/golden/shuffle_golden.jsonl``
holds permutations made by the compiled reference toolchain.
"""

from __future__ import annotations

from typing import List, Sequence


class MinstdRand:
    """std::minstd_rand: linear_congruential_engine<uint_fast32_t, 48271,
    0, 2147483647>. On LP64 Linux uint_fast32_t is 64 bits wide, so the
    seed is the 64-bit value mod 2147483647, and 0 becomes 1."""

    MULT = 48271
    MOD = 2147483647

    def __init__(self, seed: int):
        x = (seed & ((1 << 64) - 1)) % self.MOD
        self.x = 1 if x == 0 else x

    def __call__(self) -> int:
        self.x = (self.x * self.MULT) % self.MOD
        return self.x

    @property
    def min(self) -> int:
        return 1

    @property
    def max(self) -> int:
        return self.MOD - 1


def uniform_int(g: MinstdRand, a: int, b: int) -> int:
    """libstdc++ uniform_int_distribution<T>::operator() where the engine's
    range exceeds [a, b]'s (always here: ~2**31 against a few slots):
    downscaling with rejection."""
    urngrange = g.max - g.min
    urange = b - a
    assert urngrange > urange
    uerange = urange + 1
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        ret = g() - g.min
        if ret < past:
            return a + ret // scaling


def _gen_two_uniform_ints(g: MinstdRand, b0: int, b1: int):
    """libstdc++ __gen_two_uniform_ints: one draw gives two bounded ints."""
    x = uniform_int(g, 0, b0 * b1 - 1)
    return x // b1, x % b1


def shuffle(seq: Sequence, g: MinstdRand) -> List:
    """libstdc++ std::shuffle (bits/stl_algo.h): two swaps a draw while the
    engine's range over n is at least n, else one swap a draw."""
    a = list(seq)
    n = len(a)
    if n <= 1:
        return a
    if (g.max - g.min) // n >= n:
        i = 1
        if n % 2 == 0:
            # one swap first, so that an even count of swaps remains
            j = uniform_int(g, 0, 1)
            a[i], a[j] = a[j], a[i]
            i += 1
        while i < n:
            p0, p1 = _gen_two_uniform_ints(g, i + 1, i + 2)
            a[i], a[p0] = a[p0], a[i]
            i += 1
            if i == n:
                break
            a[i], a[p1] = a[p1], a[i]
            i += 1
        return a
    for i in range(1, n):
        j = uniform_int(g, 0, i)
        a[i], a[j] = a[j], a[i]
    return a


def std_hash_integral(value: int, width_bits: int) -> int:
    """libstdc++ std::hash<T> of an integral T: the value cut to T's
    width."""
    return value & ((1 << width_bits) - 1)
