"""Blocked Bloom filter: every k-mer's h bits in one 512-bit block.

Semantics and file format are the JAX package's ``models/blocked.py``: the
block is ``canonical_hash mod nblocks``; the h in-block bit offsets are the
low 9 bits of the ntHash multi-hash slots 1..h (slot 0 is the canonical
hash itself, which picks the block). A membership test reads one 64-byte
row instead of h scattered words; the false-positive rate is the
block-local one (``fpr``), slightly above a classic filter of the same
size. The ``.bbf`` format (magic ``BTLTpuBlockedBloom_v1``) is not in the
C++ reference; its bytes equal the JAX package's.

State: rows int32 [nblocks, 16] holding uint32 bits, on the filter's
device. Unlike the JAX package, whose functions return a new filter,
``insert`` and its wrappers update ``bf.rows`` in place and return ``bf``.
Inserts and queries go through the CUDA kernels ``kernels/blocked_bloom``
when the rows lie on a GPU (``insert_seq`` hashes and inserts in one
kernel), through their plain versions on the CPU.

Sizes are multiples of 512 bits up to 2**32. At exactly 2**32 the JAX
insert forms uint32 positions and drops bit 2**32 - 1 as its sentinel;
here that bit is set like any other. Above 2**32 the JAX block offset
``block * 512`` wraps in uint32, so larger sizes raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels import blocked_bloom, nthash_scan
from ..kernels.blocked_bloom import BLOCK_BITS, WORDS_PER_BLOCK

MAGIC = "BTLTpuBlockedBloom_v1"
MAX_SIZE = 1 << 32


@dataclasses.dataclass
class BlockedBloomFilter:
    rows: torch.Tensor     # int32 [nblocks, 16], uint32 bits
    size: int              # total bits (a multiple of 512)
    hash_num: int
    kmer_size: int

    @property
    def nblocks(self) -> int:
        return self.size // BLOCK_BITS

    @property
    def size_in_bytes(self) -> int:
        return self.size // 8

    @property
    def device(self) -> torch.device:
        return self.rows.device


def _check_size(size: int) -> None:
    if size % BLOCK_BITS or size < BLOCK_BITS:
        raise ValueError(f"size must be a positive multiple of {BLOCK_BITS}")
    if size > MAX_SIZE:
        raise ValueError(f"size {size} past 2**32 bits: the JAX package's "
                         "block offsets wrap in uint32 there")


def create(size: int, hash_num: int, kmer_size: int, *,
           device="cuda") -> BlockedBloomFilter:
    """Empty filter of ``size`` bits (a multiple of 512, at most 2**32) on
    ``device``."""
    _check_size(size)
    return BlockedBloomFilter(
        rows=torch.zeros((size // BLOCK_BITS, WORDS_PER_BLOCK),
                         dtype=torch.int32, device=device),
        size=size, hash_num=hash_num, kmer_size=kmer_size)


def from_numpy_rows(rows_u32: np.ndarray, size: int, hash_num: int,
                    kmer_size: int, *, device="cuda") -> BlockedBloomFilter:
    """A filter over existing uint32 rows [nblocks, 16] (for example
    ``np.asarray(jax_bf.rows)``); the rows are copied."""
    _check_size(size)
    r = np.array(rows_u32, dtype=np.uint32)     # a writable copy
    if r.shape != (size // BLOCK_BITS, WORDS_PER_BLOCK):
        raise ValueError(f"expected rows [{size // BLOCK_BITS}, "
                         f"{WORDS_PER_BLOCK}] for size {size}, got shape "
                         f"{r.shape}")
    return BlockedBloomFilter(rows=torch.from_numpy(r.view(np.int32)).to(
        device), size=size, hash_num=hash_num, kmer_size=kmer_size)


def to_numpy_rows(bf: BlockedBloomFilter) -> np.ndarray:
    """The rows as numpy uint32 [nblocks, 16] (on the host)."""
    return bf.rows.cpu().numpy().view(np.uint32)


def _block_and_bits(bf: BlockedBloomFilter, canon: torch.Tensor):
    """block index int64 [...] plus the h in-block bit offsets int64
    [..., h] of canonical hashes int64 [...] (uint64 bits)."""
    return blocked_bloom.block_and_bits(canon.to(bf.device), bf.nblocks,
                                        bf.kmer_size, bf.hash_num)


def _valid(bf: BlockedBloomFilter, valid, shape):
    if valid is None:
        return None
    return torch.as_tensor(valid).to(bf.device).broadcast_to(shape)


def insert(bf: BlockedBloomFilter, canon: torch.Tensor,
           valid=None) -> BlockedBloomFilter:
    """Insert canonical hashes int64 [...] (uint64 bits); ``valid`` (bool,
    broadcastable to canon's shape) masks k-mers out. Updates ``bf.rows``
    in place and returns ``bf``."""
    canon = canon.to(bf.device)
    blocked_bloom.insert(bf.rows, canon, bf.kmer_size, bf.hash_num,
                         _valid(bf, valid, canon.shape))
    return bf


def contains(bf: BlockedBloomFilter, canon: torch.Tensor) -> torch.Tensor:
    """Membership of canonical hashes int64 [...] -> bool [...] (all h
    bits of the block set)."""
    return blocked_bloom.contains(bf.rows, canon.to(bf.device),
                                  bf.kmer_size, bf.hash_num)


def insert_frames(bf: BlockedBloomFilter, frames) -> BlockedBloomFilter:
    """Insert the valid windows of ``ops.nthash.hash_frames`` output
    (slot 0 of its hashes is the canonical hash). Updates in place."""
    return insert(bf, frames.hashes[..., 0], frames.valid)


def contains_frames(bf: BlockedBloomFilter, frames) -> torch.Tensor:
    """Membership of every window of ``hash_frames`` output; invalid
    windows are False."""
    canon = frames.hashes[..., 0].to(bf.device)
    return blocked_bloom.contains(bf.rows, canon, bf.kmer_size, bf.hash_num,
                                  _valid(bf, frames.valid, canon.shape))


def _canon_seq(bf: BlockedBloomFilter, codes):
    """Canonical hashes int64 [B, W] and valid [B, W] of codes [..., L]
    flattened to [B, L], through the ntHash kernel's hash mode, and the
    windows' shape [..., W]."""
    codes = torch.as_tensor(codes).to(bf.device)
    hashes, _strand, valid = nthash_scan.hash_frames_planes(
        codes.reshape(-1, codes.shape[-1]), bf.kmer_size, 1)
    return hashes[0], valid, codes.shape[:-1] + valid.shape[-1:]


def insert_seq(bf: BlockedBloomFilter, codes) -> BlockedBloomFilter:
    """Insert every valid k-mer window of a sequence or a batch of
    equal-length sequences (codes [..., L], A=0 C=1 G=2 T=3, any code >= 4
    an N): ntHash and the insert in one kernel on a GPU. Updates
    ``bf.rows`` in place and returns ``bf``."""
    codes = torch.as_tensor(codes).to(bf.device)
    blocked_bloom.insert_seq(bf.rows, codes.reshape(-1, codes.shape[-1]),
                             bf.kmer_size, bf.hash_num)
    return bf


def contains_seq(bf: BlockedBloomFilter, codes):
    """Membership of every window: (hit bool [..., W], valid bool
    [..., W]); invalid windows are reported False."""
    canon, valid, shape = _canon_seq(bf, codes)
    hit = blocked_bloom.contains(bf.rows, canon, bf.kmer_size, bf.hash_num,
                                 valid)
    return hit.reshape(shape), valid.reshape(shape)


def fpr(bf: BlockedBloomFilter, n_inserted: int) -> float:
    """Expected block-local FPR after n insertions: a Poisson sum over the
    per-block load (Putze et al.), as the JAX package computes it."""
    lam = n_inserted * BLOCK_BITS / bf.size
    total, p = 0.0, math.exp(-lam)
    for i in range(0, int(lam + 10 * math.sqrt(lam + 1)) + 1):
        local = (1.0 - (1.0 - 1.0 / BLOCK_BITS) ** (i * bf.hash_num)) \
            ** bf.hash_num
        total += p * local
        p *= lam / (i + 1)
    return total


# --- serialization (the JAX package's native format) ----------------------

_FIELD_ORDER = ["BlockBits", "KmerSize", "HashNum", "BloomFilterSize",
                "BloomFilterSizeInBytes"]


def store(bf: BlockedBloomFilter, path: str) -> None:
    from ..io import bf_format

    header = bf_format._header_bytes(MAGIC, _FIELD_ORDER, {
        "BlockBits": BLOCK_BITS, "KmerSize": bf.kmer_size,
        "HashNum": bf.hash_num, "BloomFilterSize": bf.size,
        "BloomFilterSizeInBytes": bf.size_in_bytes})
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(to_numpy_rows(bf), dtype="<u4"))


def load(path: str, *, device="cuda") -> BlockedBloomFilter:
    from ..io import bf_format

    with open(path, "rb") as f:
        data = f.read()
    fields, off = bf_format.parse_header(data, MAGIC)
    size = int(fields["BloomFilterSize"])
    rows = np.frombuffer(data, dtype="<u4", count=size // 32,
                         offset=off).reshape(-1, WORDS_PER_BLOCK)
    return from_numpy_rows(rows, size, int(fields["HashNum"]),
                           int(fields["KmerSize"]), device=device)
