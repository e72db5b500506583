"""Classic Bloom filter: a bit array held as a ``torch.int32`` word tensor.

Bit p lives in word p >> 5, bit p & 31, as in the reference's
``models/bloom.py``; the little-endian bytes of the words are the
reference's byte array, so ``.bf`` files are byte-identical.

Unlike the JAX reference, whose functions return a new filter, ``insert``,
``insert_sentinel_positions`` and ``insert_and_check[_sequential]`` update
``bf.words`` in place (and return ``bf``): at 2**30 bits a copy per batch
would move 256 MiB for nothing.

The insert and query go through the CUDA kernels ``kernels/scatter_or``
and ``kernels/gather_words`` when the words lie on a GPU, and through their
plain versions on the CPU. Filters of 2**32 bits or more are not supported
yet: the positions are uint32 with 0xFFFFFFFF as the sentinel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import gather_words, scatter_or
from ..ops import u64

_WORD_BITS = 32


@dataclasses.dataclass
class BloomFilter:
    """Bit-array Bloom filter state."""

    words: torch.Tensor   # int32[ceil(size/32)], uint32 bits
    size: int             # filter size in bits
    hash_num: int
    kmer_size: int
    dfpr: float = 0.0
    n_entry: int = 0
    t_entry: int = 0

    @property
    def size_in_bytes(self) -> int:
        return self.size // 8

    @property
    def device(self) -> torch.device:
        return self.words.device


def _num_words(size: int) -> int:
    return (size + _WORD_BITS - 1) // _WORD_BITS


def create(size: int, hash_num: int, kmer_size: int, *, dfpr: float = 0.0,
           n_entry: int = 0, t_entry: int = 0,
           device="cuda") -> BloomFilter:
    """Empty filter of ``size`` bits (a multiple of 8) on ``device``."""
    if size % 8 != 0:
        raise ValueError(f"filter size {size} is not a multiple of 8")
    return BloomFilter(
        words=torch.zeros(_num_words(size), dtype=torch.int32, device=device),
        size=size, hash_num=hash_num, kmer_size=kmer_size, dfpr=dfpr,
        n_entry=n_entry, t_entry=t_entry)


def calc_optimal_size(entries: int, fpr: float, hash_num: int) -> int:
    """The reference's sizing math (rounds up to a multiple of 64)."""
    non64 = int(-float(entries) * float(hash_num) /
                math.log(1.0 - math.pow(fpr, 1.0 / float(hash_num))))
    return non64 + (64 - non64 % 64)


def calc_opti_hash_num(fpr: float) -> int:
    return int(-math.log(fpr) / math.log(2))


def create_from_fpr(expected_entries: int, fpr: float, hash_num: int,
                    kmer_size: int, *, device="cuda") -> BloomFilter:
    """FPR-sized constructor; hash_num 0 picks the optimal count."""
    if hash_num == 0:
        hash_num = calc_opti_hash_num(fpr)
    size = calc_optimal_size(expected_entries, fpr, hash_num)
    return create(size, hash_num, kmer_size, dfpr=fpr, device=device)


def from_numpy_words(words_u32: np.ndarray, size: int, hash_num: int,
                     kmer_size: int, *, dfpr: float = 0.0, n_entry: int = 0,
                     t_entry: int = 0, device="cuda") -> BloomFilter:
    """A filter over existing uint32 words (for example
    ``np.asarray(jax_bf.words)``); the words are copied."""
    if size % 8 != 0:
        raise ValueError(f"filter size {size} is not a multiple of 8")
    w = np.array(words_u32, dtype=np.uint32)    # a writable copy
    if w.shape != (_num_words(size),):
        raise ValueError(f"expected {_num_words(size)} words for size "
                         f"{size}, got shape {w.shape}")
    return BloomFilter(words=torch.from_numpy(w.view(np.int32)).to(device),
                       size=size, hash_num=hash_num, kmer_size=kmer_size,
                       dfpr=dfpr, n_entry=n_entry, t_entry=t_entry)


def to_numpy_words(bf: BloomFilter) -> np.ndarray:
    """The words as numpy uint32 (on the host)."""
    return bf.words.cpu().numpy().view(np.uint32)


def _require_u32_size(bf: BloomFilter) -> None:
    if bf.size >= (1 << 32):
        raise NotImplementedError("filters of 2**32 bits or more are not "
                                  "ported yet (positions are uint32)")


def hash_positions(hashes: torch.Tensor, size: int) -> torch.Tensor:
    """hash % size as int32 uint32 bits, same shape (size < 2**32)."""
    return u64.to_u32_bits(u64.mod_const(hashes, size))


# ---------------------------------------------------------------------------
# core ops
# ---------------------------------------------------------------------------

def insert_sentinel_positions(bf: BloomFilter,
                              pos: torch.Tensor) -> BloomFilter:
    """Insert bit positions already reduced mod size (int32 holding uint32
    bits, any shape and order), skipping 0xFFFFFFFF (-1): the array the
    ntHash kernel's positions mode writes. Updates ``bf.words`` in place."""
    _require_u32_size(bf)
    scatter_or.scatter_or(bf.words, pos.to(bf.device))
    return bf


def contains_sentinel_positions(bf: BloomFilter,
                                pos: torch.Tensor) -> torch.Tensor:
    """Membership for position planes pos int32 [h, ...] reduced mod size,
    where invalid windows carry the sentinel in every slot. Returns hit
    bool [...], False for invalid windows."""
    _require_u32_size(bf)
    return gather_words.gather_words(bf.words, pos.to(bf.device))


def insert(bf: BloomFilter, hashes: torch.Tensor,
           valid=None) -> BloomFilter:
    """Insert frames: hashes int64 [..., h] (uint64 bits); ``valid`` is an
    optional bool mask broadcastable to hashes.shape[:-1] (frames with
    valid False contribute nothing). Updates ``bf.words`` in place."""
    _require_u32_size(bf)
    hashes = hashes.to(bf.device)
    pos = hash_positions(hashes, bf.size)
    if valid is not None:
        v = torch.as_tensor(valid, device=bf.device)[..., None]
        pos = torch.where(v, pos, -1)
    return insert_sentinel_positions(bf, pos)


def contains(bf: BloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """Membership of frames: hashes int64 [..., h] -> bool [...] (all h
    bits set)."""
    _require_u32_size(bf)
    pos = hash_positions(hashes.to(bf.device), bf.size)
    return contains_sentinel_positions(bf, pos.movedim(-1, 0))


def insert_and_check(bf: BloomFilter, hashes: torch.Tensor, valid=None):
    """Batched insertAndCheck: returns ``(bf, found)``, where ``found``
    (bool [...]) is membership *before this batch*, not masked by
    ``valid``, as the reference's batched form reports it; a later
    duplicate in the batch of an earlier frame reports False. Updates
    ``bf.words`` in place."""
    found = contains(bf, hashes)
    return insert(bf, hashes, valid), found


def insert_and_check_sequential(bf: BloomFilter, hashes: torch.Tensor,
                                valid=None):
    """Order-exact insertAndCheck: frame i (in flat order) reports whether
    all its bits were set at its own insert time, that is set before the
    batch or by a valid frame before it; its own bits do not count, and
    invalid frames report False and insert nothing. Returns ``(bf,
    found)``, ``bf.words`` updated in place.

    No scan: for every bit position p of a valid frame, ``first[p]`` is
    the smallest valid frame index that holds p (a ``scatter_reduce`` with
    ``amin``), and ``found_i = valid_i & AND_j(set_before(p_ij) |
    first[p_ij] < i)``."""
    _require_u32_size(bf)
    hashes = hashes.to(bf.device)
    h = hashes.shape[-1]
    frames = hashes.shape[:-1]
    pos = hash_positions(hashes.reshape(-1, h), bf.size)      # [n, h]
    n = pos.shape[0]
    if valid is None:
        v = torch.ones(n, dtype=torch.bool, device=bf.device)
    else:
        v = torch.as_tensor(valid, device=bf.device).broadcast_to(
            frames).reshape(-1)
    before = gather_words.gather_words(bf.words, pos.reshape(1, -1))
    uniq, inv = torch.unique(pos.reshape(-1), return_inverse=True)
    frame = torch.arange(n, device=bf.device)
    frame = torch.where(v, frame, n)[:, None].expand(n, h).reshape(-1)
    first = torch.full((uniq.numel(),), n, dtype=torch.int64,
                       device=bf.device).scatter_reduce_(
        0, inv.reshape(-1), frame, "amin")
    earlier = first[inv].reshape(n, h) < torch.arange(
        n, device=bf.device)[:, None]
    found = v & (before.reshape(n, h) | earlier).all(dim=1)
    insert_sentinel_positions(bf, torch.where(v[:, None], pos, -1))
    return bf, found.reshape(frames)


def get_pop(bf: BloomFilter) -> int:
    """Number of set bits."""
    return int(u64.popcount32(bf.words).sum())


def get_fpr(bf: BloomFilter) -> float:
    """Popcount-based measured FPR: (pop / size) ** hash_num."""
    return (get_pop(bf) / bf.size) ** bf.hash_num


def calc_fpr_num_inserted(bf: BloomFilter, num: int) -> float:
    return math.pow(1.0 - math.pow(1.0 - 1.0 / float(bf.size),
                                   float(num) * bf.hash_num),
                    float(bf.hash_num))
