"""Sequence-level wrappers over ``models/bloom.py``: hash every k-mer
window of a read batch and insert or query it.

``insert_seq`` / ``contains_seq`` run the build/query path: the ntHash
kernel's positions mode (hash, mod size and the invalid-window sentinel in
one pass), then the scatter-OR or gather kernel. On the CPU the same calls
take the kernels' plain versions. Codes may be numpy or torch, uint8
[..., L] with A=0 C=1 G=2 T=3 and any code >= 4 an N.

How codes reach the filter's device (``staging.codes_on``, which the
counting filter shares): a pageable host batch going to a CUDA device
passes through the device's staging ring (``utils/staging.py``): copied on
the host into pinned slots, moved to the card on a copy stream, hashed on
the current stream once its copy has ended. ``contains_seq`` hashes and
gathers chunk by chunk, so the copy of one chunk runs under the kernels of
the one before; ``insert_seq`` stages the whole batch and launches one hash
and one scatter, and returns without waiting for the card. Pinned and
CUDA codes are moved as they are (``to``), and a CPU filter takes its
codes in place. Either way the caller's array is free again when the call
returns. Each call records its spans
(``btl.insert_seq`` / ``btl.contains_seq`` around the staging, hash,
scatter or gather spans) and counters (``utils/trace.py``).
"""

from __future__ import annotations

import torch

from ..kernels import nthash_scan
from ..ops import nthash_tables
from ..utils import staging, trace
from . import bloom

def _positions(bf: bloom.BloomFilter, flat: torch.Tensor):
    """Positions planes [h, B, W] (in the form
    ``bloom.position_dtype(bf.size)``) and valid [B, W] for codes [B, L]."""
    pos, _strand, valid = nthash_scan.positions_planes(
        flat, bf.kmer_size, bf.hash_num, bf.size)
    return pos, valid


def insert_seq(bf: bloom.BloomFilter, codes) -> bloom.BloomFilter:
    """Insert every valid k-mer window of a sequence or a batch of
    equal-length sequences (codes [..., L]). Updates ``bf.words`` in place
    and returns ``bf``; on a CUDA filter the insert is queued on the current
    stream and the call does not wait for it."""
    trace.count("calls.insert_seq")
    with trace.span("btl.insert_seq"):
        (pos, _valid), = staging.codes_on(bf.device, torch.as_tensor(codes),
                                          lambda c: _positions(bf, c))
        return bloom.insert_sentinel_positions(bf, pos)


def contains_seq(bf: bloom.BloomFilter, codes):
    """Membership of every window: (hit bool [..., W], valid bool [..., W]);
    invalid windows are reported False. The rows are hashed and gathered
    chunk by chunk (``staging.plan``) when they come through the staging
    ring."""
    trace.count("calls.contains_seq")
    with trace.span("btl.contains_seq"):
        codes = torch.as_tensor(codes)
        hits, valids = [], []
        for pos, valid in staging.codes_on(bf.device, codes,
                                           lambda c: _positions(bf, c),
                                           split=True):
            hits.append(bloom.contains_sentinel_positions(bf, pos))
            valids.append(valid)
        hit, valid = (x[0] if len(x) == 1 else torch.cat(x)
                      for x in (hits, valids))
        shape = codes.shape[:-1] + valid.shape[-1:]
        return hit.reshape(shape), valid.reshape(shape)


def _kmer_hashes(bf: bloom.BloomFilter, kmer_codes) -> torch.Tensor:
    """Hashes int64 [..., h] of the first window of each row of codes
    [..., k], through the ntHash kernel's hash mode. A k-mer holding a
    non-ACGT base hashes through seed 0, as the reference's k-mer insert
    does (no validity mask)."""
    codes = torch.as_tensor(kmer_codes)
    (hashes, _strand, _valid), = staging.codes_on(
        bf.device, codes, lambda c: nthash_scan.hash_frames_planes(
            c, bf.kmer_size, bf.hash_num))
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
