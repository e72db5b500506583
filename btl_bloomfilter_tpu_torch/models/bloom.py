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
plain versions on the CPU. Bit positions come in two forms, by filter size
(``position_dtype``): below 2**32 bits int32 holding uint32 bits, with
0xFFFFFFFF (-1) as the sentinel; from 2**32 bits int64, with -1 as the
sentinel (at 2**32 exactly 0xFFFFFFFF is a real position). Filters go up to
2**36 bits (``nthash_scan.MAX_SIZE``): the reference's word index is int32
and wraps past that, so larger sizes raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import gather_words, nthash_scan, scatter_or
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


def _check_size(size: int) -> None:
    if size % 8 != 0:
        raise ValueError(f"filter size {size} is not a multiple of 8")
    nthash_scan.check_size(size)


def create(size: int, hash_num: int, kmer_size: int, *, dfpr: float = 0.0,
           n_entry: int = 0, t_entry: int = 0,
           device="cuda") -> BloomFilter:
    """Empty filter of ``size`` bits (a multiple of 8, at most 2**36) on
    ``device``."""
    _check_size(size)
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
    _check_size(size)
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


def position_dtype(size: int) -> torch.dtype:
    """The form of a filter's bit positions: torch.int32 (uint32 bits,
    sentinel 0xFFFFFFFF) below 2**32 bits, torch.int64 (sentinel -1) from
    2**32 bits."""
    return torch.int64 if size >= nthash_scan.WIDE_SIZE else torch.int32


def _require_positions(bf: BloomFilter, pos: torch.Tensor) -> None:
    nthash_scan.check_size(bf.size)
    if pos.dtype != position_dtype(bf.size):
        raise TypeError(f"a filter of {bf.size} bits takes positions of "
                        f"{position_dtype(bf.size)}, got {pos.dtype}")


def hash_positions(hashes: torch.Tensor, size: int) -> torch.Tensor:
    """hash % size in the form ``position_dtype(size)``, same shape."""
    nthash_scan.check_size(size)
    pos = u64.mod_const(hashes, size)
    return u64.to_u32_bits(pos) if size < nthash_scan.WIDE_SIZE else pos


# ---------------------------------------------------------------------------
# core ops
# ---------------------------------------------------------------------------

def insert_sentinel_positions(bf: BloomFilter,
                              pos: torch.Tensor) -> BloomFilter:
    """Insert bit positions already reduced mod size (any shape and order,
    in the form ``position_dtype(bf.size)``), skipping the sentinel -1: the
    array the ntHash kernel's positions mode writes. Updates ``bf.words``
    in place."""
    _require_positions(bf, pos)
    scatter_or.scatter_or(bf.words, pos.to(bf.device))
    return bf


def contains_sentinel_positions(bf: BloomFilter,
                                pos: torch.Tensor) -> torch.Tensor:
    """Membership for position planes pos [h, ...] reduced mod size (in
    the form ``position_dtype(bf.size)``), where invalid windows carry the
    sentinel in every slot. Returns hit bool [...], False for invalid
    windows."""
    _require_positions(bf, pos)
    return gather_words.gather_words(bf.words, pos.to(bf.device))


def insert(bf: BloomFilter, hashes: torch.Tensor,
           valid=None) -> BloomFilter:
    """Insert frames: hashes int64 [..., h] (uint64 bits); ``valid`` is an
    optional bool mask broadcastable to hashes.shape[:-1] (frames with
    valid False contribute nothing). Updates ``bf.words`` in place."""
    hashes = hashes.to(bf.device)
    pos = hash_positions(hashes, bf.size)
    if valid is not None:
        v = torch.as_tensor(valid, device=bf.device)[..., None]
        pos = torch.where(v, pos, -1)
    return insert_sentinel_positions(bf, pos)


def contains(bf: BloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """Membership of frames: hashes int64 [..., h] -> bool [...] (all h
    bits set)."""
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
    first[p_ij] < i)``. Filters up to 2**32 bits, as the reference's."""
    if bf.size > nthash_scan.WIDE_SIZE:
        raise NotImplementedError("sequential check requires size <= 2**32")
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


# words a popcount takes at a time: its int64 temporaries over a whole
# filter of 2**36 bits would take several times the filter's 8 GiB
_POP_CHUNK = 1 << 26


def get_pop(bf: BloomFilter) -> int:
    """Number of set bits."""
    return int(sum(u64.popcount32(bf.words[i:i + _POP_CHUNK]).sum()
                   for i in range(0, bf.words.numel(), _POP_CHUNK)))


def get_fpr(bf: BloomFilter) -> float:
    """Popcount-based measured FPR: (pop / size) ** hash_num."""
    return (get_pop(bf) / bf.size) ** bf.hash_num


def calc_fpr_num_inserted(bf: BloomFilter, num: int) -> float:
    return math.pow(1.0 - math.pow(1.0 - 1.0 / float(bf.size),
                                   float(num) * bf.hash_num),
                    float(bf.hash_num))


def _require_entries(bf: BloomFilter) -> None:
    if bf.n_entry <= 0:
        raise ValueError("the filter's n_entry must be set (> 0)")


def get_fpr_num_ele(bf: BloomFilter) -> float:
    """The FPR expected after ``n_entry`` insertions (getFPR_numEle)."""
    _require_entries(bf)
    return calc_fpr_num_inserted(bf, bf.n_entry)


def get_redundancy_fpr(bf: BloomFilter) -> float:
    """The mean FPR over the 1st to the ``n_entry``-th insertion
    (getRedudancyFPR, BloomFilter.hpp:333-341)."""
    _require_entries(bf)
    total = math.log(calc_fpr_num_inserted(bf, 1))
    for i in range(2, bf.n_entry):
        total = math.log(math.exp(total) + calc_fpr_num_inserted(bf, i))
    return math.exp(total) / bf.n_entry
