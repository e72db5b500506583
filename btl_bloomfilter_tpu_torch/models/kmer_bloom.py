"""Sequence-level wrappers over ``models/bloom.py``: hash every k-mer
window of a read batch and insert or query it.

``insert_seq`` / ``contains_seq`` run the build/query path: the ntHash
kernel's positions mode (hash, mod size and the invalid-window sentinel in
one pass), then the scatter-OR or gather kernel. On the CPU the same calls
take the kernels' plain versions. Codes may be numpy or torch, uint8
[..., L] with A=0 C=1 G=2 T=3 and any code >= 4 an N; they are moved to
the filter's device. Each call records its spans (``btl.insert_seq`` /
``btl.contains_seq`` around the staging, hash, scatter or gather spans) and
counters (``utils/trace.py``).
"""

from __future__ import annotations

import torch

from ..kernels import nthash_scan
from ..ops import nthash_tables
from ..utils import trace
from . import bloom

STAGE_SPANS = {k: f"btl.stage.{k}" for k in ("pageable", "pinned", "none")}
STAGE_BYTES = {k: f"stage_bytes.{k}" for k in STAGE_SPANS}


def _codes_on(bf: bloom.BloomFilter, codes) -> torch.Tensor:
    """codes on the filter's device, in a ``btl.stage.*`` span named by
    ``trace.stage_kind``; their bytes count under ``stage_bytes.*``."""
    kind = trace.stage_kind(codes, bf.device)
    with trace.span(STAGE_SPANS[kind]):
        codes = torch.as_tensor(codes)
        trace.count(STAGE_BYTES[kind], codes.numel() * codes.element_size())
        return codes.to(bf.device)


def _positions(bf: bloom.BloomFilter, codes: torch.Tensor):
    """Positions planes [h, B, W] (in the form
    ``bloom.position_dtype(bf.size)``) and valid [B, W] for codes [..., L]
    flattened to [B, L]."""
    flat = codes.reshape(-1, codes.shape[-1])
    pos, _strand, valid = nthash_scan.positions_planes(
        flat, bf.kmer_size, bf.hash_num, bf.size)
    return pos, valid


def insert_seq(bf: bloom.BloomFilter, codes) -> bloom.BloomFilter:
    """Insert every valid k-mer window of a sequence or a batch of
    equal-length sequences (codes [..., L]). Updates ``bf.words`` in place
    and returns ``bf``."""
    trace.count("calls.insert_seq")
    with trace.span("btl.insert_seq"):
        pos, _valid = _positions(bf, _codes_on(bf, codes))
        return bloom.insert_sentinel_positions(bf, pos)


def contains_seq(bf: bloom.BloomFilter, codes):
    """Membership of every window: (hit bool [..., W], valid bool [..., W]);
    invalid windows are reported False."""
    trace.count("calls.contains_seq")
    with trace.span("btl.contains_seq"):
        codes = _codes_on(bf, codes)
        pos, valid = _positions(bf, codes)
        hit = bloom.contains_sentinel_positions(bf, pos)
        shape = codes.shape[:-1] + valid.shape[-1:]
        return hit.reshape(shape), valid.reshape(shape)


def _kmer_hashes(bf: bloom.BloomFilter, kmer_codes) -> torch.Tensor:
    """Hashes int64 [..., h] of the first window of each row of codes
    [..., k], through the ntHash kernel's hash mode. A k-mer holding a
    non-ACGT base hashes through seed 0, as the reference's k-mer insert
    does (no validity mask)."""
    codes = _codes_on(bf, kmer_codes)
    flat = codes.reshape(-1, codes.shape[-1])
    hashes, _strand, _valid = nthash_scan.hash_frames_planes(
        flat, bf.kmer_size, bf.hash_num)
    return hashes[:, :, 0].movedim(0, -1).reshape(
        codes.shape[:-1] + (bf.hash_num,))


def insert_kmers(bf: bloom.BloomFilter, kmer_codes) -> bloom.BloomFilter:
    """Insert fixed-length k-mers codes [..., k]. Updates ``bf.words`` in
    place."""
    return bloom.insert(bf, _kmer_hashes(bf, kmer_codes))


def contains_kmers(bf: bloom.BloomFilter, kmer_codes) -> torch.Tensor:
    """Membership of fixed-length k-mers codes [..., k] -> bool [...]."""
    return bloom.contains(bf, _kmer_hashes(bf, kmer_codes))


def insert_string(bf: bloom.BloomFilter, seq: str) -> bloom.BloomFilter:
    return insert_seq(bf, nthash_tables.encode_seq(seq))


def contains_string(bf: bloom.BloomFilter, kmer: str) -> torch.Tensor:
    return contains_kmers(bf, nthash_tables.encode_seq(kmer))
