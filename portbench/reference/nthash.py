"""ntHash of every k-mer window, written from the C++ iterator's semantics
(``nthash.hpp``: NTF64, NTR64, NTMC64), not from the port's closed form.

A window's forward hash is XOR_i srol^(k-1-i)(seed[s_i]), its reverse hash
XOR_i srol^i(rcseed[s_i]); the canonical hash is the smaller, and hash j > 0
is t ^ (t >> 27) with t = canonical * (j ^ k * MULTI_SEED). srol rotates the
low 33 and the high 31 bits independently. The rotations are constants per
offset i, so each offset costs one lookup in a 5-entry table and one XOR.
uint64 values travel as int64 bit patterns.
"""

from __future__ import annotations

import torch

SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
         0x295549F54BE24456, 0)                     # A C G T N
COMPLEMENT = (3, 2, 1, 0, 4)
MULTI_SEED = 0x90B45D39FB6DA1FA
MULTI_SHIFT = 27
CODE_N = 4
_U64 = (1 << 64) - 1
_LOW63 = (1 << 63) - 1
_SIGN = -(1 << 63)


def signed(v: int) -> int:
    """A uint64 python int as the int64 holding its bits."""
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def srol(x: int, n: int = 1) -> int:
    """ntHash's split rotation, n times, on a python int."""
    lo, hi = x & ((1 << 33) - 1), x >> 33
    a, b = n % 33, n % 31
    lo = ((lo << a) | (lo >> (33 - a))) & ((1 << 33) - 1)
    hi = ((hi << b) | (hi >> (31 - b))) & ((1 << 31) - 1)
    return (hi << 33) | lo


def tables(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-offset lookup tables int64 [k, 5]: forward srol^(k-1-i)(seed[c])
    and reverse srol^i(seed[complement c])."""
    fwd = [[signed(srol(SEEDS[c], k - 1 - i)) for c in range(5)]
           for i in range(k)]
    rev = [[signed(srol(SEEDS[COMPLEMENT[c]], i)) for c in range(5)]
           for i in range(k)]
    return (torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(rev, dtype=torch.int64, device=device))


def encode(seq: str) -> torch.Tensor:
    """uint8 codes [1, L] of an ASCII sequence, as the C++ reader encodes
    it: A C G T (either case, U / u as T) to 0-3, anything else to N."""
    table = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
    return torch.tensor([[table.get(ch.upper(), CODE_N) for ch in seq]],
                        dtype=torch.uint8)


def valid_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """bool [B, W]: the window holds no N (any code >= 4)."""
    n = (codes >= CODE_N).to(torch.int32).cumsum(dim=1)
    n = torch.nn.functional.pad(n, (1, 0))
    return (n[:, k:] - n[:, :-k]) == 0


def canonical(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hash int64 [B, W] of every window of codes uint8 [B, L]
    (meaningless where the window holds an N)."""
    c = codes.to(torch.int64).clamp_(max=CODE_N)
    W = c.shape[1] - k + 1
    tf, tr = tables(k, c.device)
    fh = torch.zeros((c.shape[0], W), dtype=torch.int64, device=c.device)
    rh = torch.zeros_like(fh)
    for i in range(k):
        s = c[:, i:i + W]
        fh ^= tf[i][s]
        rh ^= tr[i][s]
    return torch.where((rh ^ _SIGN) < (fh ^ _SIGN), rh, fh)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned x % m for int64 bit patterns x and 1 <= m < 2**62."""
    r = torch.remainder(x & _LOW63, m)
    r += torch.where(x < 0, (1 << 63) % m, 0)
    return torch.where(r >= m, r - m, r)


def hashes(canon: torch.Tensor, k: int, h: int):
    """The h hashes of each canonical hash, one plane at a time."""
    yield canon
    for j in range(1, h):
        t = canon * signed(j ^ ((k * MULTI_SEED) & _U64))
        yield t ^ ((t >> MULTI_SHIFT) & ((1 << (64 - MULTI_SHIFT)) - 1))


def positions(codes: torch.Tensor, k: int, h: int, size: int,
              hash_bits: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions int64 [h, B, W] = hash % size, valid bool [B, W]).
    ``hash_bits`` 32 keeps only each hash's low 32 bits before the modulo:
    the lower-precision control, never the reference itself."""
    canon = canonical(codes, k)
    planes = []
    for t in hashes(canon, k, h):
        if hash_bits == 32:
            t = t & 0xFFFFFFFF
        planes.append(umod(t, size))
    return torch.stack(planes), valid_windows(codes, k)
