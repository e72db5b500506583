"""Unsigned 64-bit arithmetic on ``torch.int64`` bit patterns.

torch has no unsigned 64-bit arithmetic on the CPU (no ``%``, ``>>`` or
ordered compare on ``torch.uint64``), so hashes travel as ``int64`` holding
the uint64 bits, and the few unsigned operations ntHash needs are emulated
here. ``<<``, ``^``, ``&``, ``|`` and ``*`` already give the right low 64
bits on ``int64``. The reference's limb-pair ``U64`` machinery is not
needed: both the CPU and the GPU have 64-bit integers.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN = -(1 << 63)          # int64 with only bit 63 set
_MASK32 = 0xFFFFFFFF


def as_signed(value: int) -> int:
    """A uint64 python int (taken mod 2**64) as the int64 with its bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >> 63 else value


def from_numpy(arr) -> torch.Tensor:
    """numpy uint64 (or python ints) -> int64 tensor with the same bits."""
    return torch.from_numpy(np.asarray(arr, dtype=np.uint64).view(np.int64)
                            .copy())


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits."""
    return x.detach().cpu().numpy().view(np.uint64)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a python int 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b: flip bit 63 on both sides, then compare signed."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def min_(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum."""
    return torch.minimum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unsigned minimum along ``dim``."""
    return torch.amin(x ^ _SIGN, dim=dim) ^ _SIGN


def add_sat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a + b, saturating at 2**64-1 (all bits set, -1 as int64)
    instead of wrapping."""
    s = a + b
    return torch.where(lt(s, a), -1, s)


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 64 bits of a * c for a uint64 python int c."""
    return a * as_signed(c)


def gt_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """Unsigned x > c for a uint64 python int c."""
    return (x ^ _SIGN) > (as_signed(c) ^ _SIGN)


def mod_const(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned x % m for a python int 1 <= m < 2**47; result int64 in
    [0, m).

    The high 32 bits are reduced first; the low 32 bits are then folded in
    16 bits at a time. Each fold shifts a remainder below m left by 16, so
    no intermediate reaches 2**63 while m < 2**47, and every ``%`` acts on
    non-negative int64 values (Bloom filters go up to 2**36 bits)."""
    if not 1 <= m < (1 << 47):
        raise ValueError(f"modulus {m} outside [1, 2**47)")
    return _fold_mod(x, m)


def mod_u32(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Unsigned x % c elementwise for int64 divisors 1 <= c < 2**32 (the
    width-8 MIBF reservoir's ``std::hash<uint64_t>(v ^ id) % count``); the
    same folds as :func:`mod_const`."""
    return _fold_mod(x, c)


def _fold_mod(x: torch.Tensor, m) -> torch.Tensor:
    r = shr(x, 32) % m
    r = ((r << 16) | ((x >> 16) & 0xFFFF)) % m
    return ((r << 16) | (x & 0xFFFF)) % m


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def from_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned value as int64."""
    return x.to(torch.int64) & _MASK32


def positions64(pos: torch.Tensor) -> torch.Tensor:
    """Bit positions in either form -> int64 values, -1 for the sentinel.
    The narrow form (filters below 2**32 bits) is int32 holding uint32
    bits with 0xFFFFFFFF (-1) as the sentinel; the wide form is int64 with
    -1, and is returned as it is."""
    if pos.dtype == torch.int64:
        return pos
    p = from_u32_bits(pos)
    return torch.where(p == _MASK32, -1, p)


def unsigned(x: torch.Tensor) -> torch.Tensor:
    """uint8 values or int16 / int32 bit patterns -> their unsigned value as
    int64; int64 (uint64 bits) as it is."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & ((1 << (8 * x.element_size())) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits of each element (int32 bit patterns or
    int64 values), as int64. torch has no popcount: a SWAR bit count in
    int32, whose wrapping arithmetic gives the same bits (the cast keeps
    the low 32 bits; the top byte of the last product is at most 32), on
    two temporaries updated in place."""
    x = x.to(torch.int32)
    y = x >> 1
    y &= 0x55555555
    y = torch.sub(x, y, out=y)
    t = y >> 2
    t &= 0x33333333
    y &= 0x33333333
    y += t
    torch.bitwise_right_shift(y, 4, out=t)
    y += t
    y &= 0x0F0F0F0F
    y *= 0x01010101
    y >>= 24
    return y.to(torch.int64)
