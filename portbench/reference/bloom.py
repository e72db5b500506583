"""The reference Bloom filter: one bool a bit, set with ``index_put_``
(every writer stores True, so duplicates need no atomics), read with a
gather. writeBloom's bit p is bit p & 31 of 32-bit word p >> 5, so packing
eight bools into a byte, little-endian, gives the ``.bf`` bytes and the
port's words."""

from __future__ import annotations

import math

import torch

from . import nthash

# bits packed and compared a chunk at a time: whole-filter temporaries of a
# 59.4 Gbit filter would not fit beside it
CHUNK_BITS = 1 << 30
_BYTE_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def writebloom_specs(fasta_bytes: int, fpr: float) -> tuple[int, int]:
    """(size in bits, hash count) as writeBloom sizes a filter for a FASTA
    file of ``fasta_bytes`` bytes (``swig/writeBloom_rolling.cpp``): size =
    ceil(-n ln p / ln^2 2) rounded up past a multiple of 64, h = floor(size
    / n) * ln 2."""
    size = math.ceil((-1 * fasta_bytes * math.log(fpr))
                     / (math.log(2) * math.log(2)))
    size += 64 - (size % 64)
    return size, int((size // fasta_bytes) * math.log(2))


class Filter:
    """Reference filter of ``size`` bits for k-mers of ``k`` with ``h``
    hashes; ``hash_bits`` 32 makes the lower-precision control."""

    def __init__(self, size: int, h: int, k: int, device,
                 hash_bits: int = 64):
        self.size, self.h, self.k, self.hash_bits = size, h, k, hash_bits
        self.bits = torch.zeros(-(-size // 32) * 32, dtype=torch.bool,
                                device=device)

    def positions(self, codes: torch.Tensor):
        return nthash.positions(codes.to(self.bits.device), self.k, self.h,
                                self.size, self.hash_bits)

    def insert(self, codes: torch.Tensor) -> torch.Tensor:
        """Set the bits of every valid window of codes [B, L]; returns the
        positions [h, n] that were set."""
        pos, valid = self.positions(codes)
        pos = pos[:, valid]
        self.bits[pos.reshape(-1)] = True
        return pos

    def probe(self, codes: torch.Tensor):
        """(bits bool [h, B, W] of every window's h positions, valid [B, W])."""
        pos, valid = self.positions(codes)
        return self.bits[pos], valid

    def words(self, start: int, stop: int) -> torch.Tensor:
        """int32 words [start, stop) of the filter, as the port holds them."""
        b = self.bits[start * 32:stop * 32].view(torch.uint8).view(-1, 8)
        w = torch.tensor(_BYTE_WEIGHTS, dtype=torch.uint8, device=b.device)
        return (b * w).sum(dim=1, dtype=torch.uint8).view(torch.int32)

    def words_differing(self, words: torch.Tensor) -> int:
        """How many of the port's int32 words differ from the reference's."""
        if words.numel() * 32 != self.bits.numel():
            return max(words.numel(), self.bits.numel() // 32)
        step, n = CHUNK_BITS // 32, 0
        for i in range(0, words.numel(), step):
            j = min(i + step, words.numel())
            n += int((self.words(i, j) != words[i:j].to(self.bits.device))
                     .sum())
        return n


def distinct_words(pos: torch.Tensor) -> int:
    """Distinct 32-bit filter words the positions touch."""
    return int(torch.unique(pos.reshape(-1) >> 5).numel())


def query_loads(bits: torch.Tensor, valid: torch.Tensor) -> int:
    """Filter words a query must load: for each valid window, its h probes
    up to and including the first clear bit (all h on a hit)."""
    clear = ~bits
    first = clear.to(torch.uint8).argmax(dim=0) + 1
    loads = torch.where(clear.any(dim=0), first, bits.shape[0])
    return int(loads[valid].sum())
