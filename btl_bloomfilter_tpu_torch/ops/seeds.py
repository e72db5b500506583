"""Spaced-seed ntHash in plain PyTorch: stHash and ssHash of every window.

Semantics are the reference's ``ops/seeds.py`` (stHashIterator.hpp,
ssHashIterator.hpp). A spaced seed is a k-length string of '1' / '0'; the
offsets marked '0' are masked out of the hash. ntHash masks an offset by
XORing its term out of the window's forward and reverse hashes, and the
rotation of offset i's term is static: k-1-i on the forward strand, i on
the reverse. So a seed's masked hashes are the window's (fh, rh) with a few
statically rotated, shifted slices of the per-base seeds XORed in.

``spaced_hash_frames`` is the stHashIterator (m seeds x m2 hashes a
window, seed-major, a strand flag per hash) and the plain version of the
spaced-hash kernel (``kernels/spaced_scan.py``); ``single_spaced_hash`` is
the ssHashIterator, with its window-0 quirk. Hashes are int64 tensors
holding the uint64 bits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from . import nthash, nthash_tables as T, u64

_SEEDS = u64.from_numpy(T.SEEDS)
_RC_SEEDS = u64.from_numpy(T.RC_SEEDS)


def parse_seed_strings(seeds: Sequence[str]) -> List[List[int]]:
    """'1'/'0' strings -> each seed's masked (not '1') offsets
    (stHashIterator::parseSeed, MIBloomFilter::parseSeedString)."""
    return [[j for j, ch in enumerate(s) if ch != "1"] for s in seeds]


def seed_length(seed_strings: Sequence[str]) -> int:
    """The seeds' common length k; seeds of unequal length raise."""
    k = len(seed_strings[0])
    if any(len(s) != k for s in seed_strings):
        raise ValueError("spaced seeds must share one length")
    return k


@dataclasses.dataclass(frozen=True)
class SpacedFrames:
    """Per-window spaced-seed hashes.

    hashes: int64 [..., W, m*m2] (uint64 bits), seed-major like the
    reference ([seed1 hash1 .. seed1 hash m2, seed2 hash1, ...]);
    strand: bool [..., W, m*m2], True where the reverse strand is
    canonical; valid: bool [..., W], the window holds no N (masked offsets
    included)."""

    hashes: torch.Tensor
    strand: torch.Tensor
    valid: torch.Tensor


def _base_seeds(codes: torch.Tensor):
    """Per-position forward and reverse-complement seeds, int64 [..., L]."""
    c = nthash._seed_index(codes)
    return _SEEDS.to(codes.device)[c], _RC_SEEDS.to(codes.device)[c]


def _srol_static(v: torch.Tensor, t: int) -> torch.Tensor:
    return nthash.srol_pow(v, t % 33, t % 31)


def _masked_strand_vals(sf, sr, sh: nthash.StrandHashes, k: int,
                        zero_offsets: Sequence[int]):
    """One seed's mask applied to every window's fh / rh."""
    W = sh.fh.shape[-1]
    fs, rs = sh.fh, sh.rh
    for i in zero_offsets:
        fs = fs ^ _srol_static(sf[..., i:i + W], k - 1 - i)
        rs = rs ^ _srol_static(sr[..., i:i + W], i)
    return fs, rs


def spaced_hash_frames(codes: torch.Tensor, seed_strings: Sequence[str],
                       m2: int = 1) -> SpacedFrames:
    """Every window's m seeds x m2 hashes: draining an stHashIterator."""
    codes = torch.as_tensor(codes)
    k = seed_length(seed_strings)
    sh = nthash.strand_hashes(codes, k)
    sf, sr = _base_seeds(codes)
    hashes, strands = [], []
    for zeros in parse_seed_strings(seed_strings):
        fs, rs = _masked_strand_vals(sf, sr, sh, k, zeros)
        st = u64.lt(rs, fs)
        derived = nthash.derive_hashes(torch.where(st, rs, fs), k, m2)
        hashes.append(derived)
        strands.append(st[..., None].expand(derived.shape))
    return SpacedFrames(hashes=torch.cat(hashes, dim=-1),
                        strand=torch.cat(strands, dim=-1), valid=sh.valid)


def single_spaced_hash(codes: torch.Tensor, seed_string: str) -> torch.Tensor:
    """One spaced-seed value a window, int64 [..., W]: draining an
    ssHashIterator. Plain torch on either device: no CLI path runs it.

    Keeps the reference's split between window 0 and the slid windows
    (ssHashIterator.hpp:44-62): window 0 uses the base formula, which masks
    only offset k-1 (where that seed column is '0'); every later window
    uses the sliding formula, which masks each '0' offset with rotation k.
    No window is skipped for an N."""
    codes = torch.as_tensor(codes)
    k = len(seed_string)
    sh = nthash.strand_hashes(codes, k)
    W = sh.fh.shape[-1]
    sf, _ = _base_seeds(codes)
    sval = sh.fh
    for i, ch in enumerate(seed_string):
        if ch != "1":
            sval = sval ^ _srol_static(sf[..., i:i + W], k)
    base0 = sh.fh[..., 0]
    if seed_string[k - 1] != "1":
        base0 = base0 ^ sf[..., k - 1]
    sval = sval.clone()
    sval[..., 0] = base0
    return sval
