"""The reference counting Bloom filter: btl_bloomfilter's
``CountingBloomFilter<uint8_t>`` (CountingBloomFilter.hpp:135-204), one
uint8 a counter, in plain torch and integer arithmetic only.

An insert is incrementMin over every valid window, in stream order (row
after row, window after window): each of the frame's h counters that
equals the frame's minimum goes up by one, a counter the frame names twice
once (the C++ loop's compare-and-swap finds it already raised), and
nothing moves once the minimum is 255. Frames that share no counter
commute, so a batch is applied in rounds: a frame's round is the length of
the longest chain of earlier frames, each sharing a counter with the next,
that ends in it. The rounds are found by peeling: a frame joins the
current round when, among the frames left, it is the first user of each of
its counters. Within a round the frames are counter-disjoint and are
applied at once: gather, min, raise the counters equal to the min.

A membership query is min-of-h >= ``count_threshold`` (:190-196). The
reference imports nothing of the port and reads nothing the port computed:
only the codes the benchmark made, hashed by ``nthash.positions``.
"""

from __future__ import annotations

import torch

from . import nthash

COUNTER_MAX = 255
# counters compared a chunk at a time
CHUNK = 1 << 28


class Counters:
    """``size`` one-byte counters for k-mers of ``k`` with ``h`` hashes."""

    def __init__(self, size: int, h: int, k: int, device):
        self.size, self.h, self.k = size, h, k
        self.counts = torch.zeros(size, dtype=torch.uint8, device=device)

    def frames(self, codes: torch.Tensor) -> torch.Tensor:
        """Positions int64 [n, h] of the valid windows of codes [B, L], in
        stream order."""
        pos, valid = nthash.positions(codes.to(self.counts.device), self.k,
                                      self.h, self.size)
        return pos.reshape(self.h, -1)[:, valid.reshape(-1)].T

    def insert(self, codes: torch.Tensor) -> torch.Tensor:
        """incrementMin of every valid window of codes [B, L]; returns the
        frames [n, h] applied."""
        frames = self.frames(codes)
        self.apply(frames)
        return frames

    def apply(self, frames: torch.Tensor) -> int:
        """incrementMin of frames [n, h] in stream order; returns the
        number of rounds."""
        n, h = frames.shape
        if n == 0:
            return 0
        slot, inv = torch.unique(frames.reshape(-1), return_inverse=True)
        inv = inv.view(n, h)
        left = torch.arange(n, device=frames.device)
        rounds = 0
        while left.numel():
            # each counter's first user among the frames left
            first = torch.full((slot.numel(),), n, dtype=torch.int64,
                               device=frames.device)
            first.scatter_reduce_(0, inv[left].reshape(-1),
                                  left.repeat_interleave(h), "amin")
            ready = (first[inv[left]] == left[:, None]).all(dim=1)
            self._round(frames[left[ready]])
            left = left[~ready]
            rounds += 1
        return rounds

    def _round(self, frames: torch.Tensor) -> None:
        """incrementMin of counter-disjoint frames [m, h] at once."""
        cur = self.counts[frames].to(torch.int16)
        low = cur.amin(dim=1, keepdim=True)
        raise_ = (cur == low) & (low < COUNTER_MAX)
        self.counts[frames[raise_]] = (low + 1).expand_as(cur)[raise_].to(
            torch.uint8)

    def min_counts(self, codes: torch.Tensor):
        """(min of the h counters int64 [B, W], valid bool [B, W])."""
        pos, valid = nthash.positions(codes.to(self.counts.device), self.k,
                                      self.h, self.size)
        return self.counts[pos].amin(dim=0).to(torch.int64), valid

    def words_differing(self, words: torch.Tensor) -> int:
        """How many of the port's int32 words (four counters each, counter
        p in byte p & 3 of word p >> 2, little-endian) differ from the
        reference's counters."""
        mine = self.counts.view(torch.int32)
        if words.numel() != mine.numel():
            return max(words.numel(), mine.numel())
        n = 0
        for i in range(0, mine.numel(), CHUNK):
            j = min(i + CHUNK, mine.numel())
            n += int((mine[i:j] != words[i:j].to(mine.device)).sum())
        return n


def distinct_words(frames: torch.Tensor) -> int:
    """Distinct 32-bit counter words (four counters each) the frames
    touch."""
    return int(torch.unique(frames.reshape(-1) >> 2).numel())
