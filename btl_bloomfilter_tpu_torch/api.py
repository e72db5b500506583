"""Batch pipelines over the k-mer filter, keyed by length bucket.

The reference compiles one jitted graph per length bucket; PyTorch runs
eagerly, so here the pipelines keep only the bucketing (sequence lengths
padded up to powers of two with the N code, so padded windows are invalid)
and move host batches to the filter's device. ``BloomPipeline`` runs the
build/query path of ``models/kmer_bloom.py``: on a GPU, the ntHash,
scatter-OR and gather kernels. ``MIBFConstructPipeline`` runs the 4-phase
MIBF build of ``models/mibf_construct.py``: on a GPU, the ntHash (or, for a
filter with spaced seeds, the spaced-hash), scatter-OR and MIBF rank
kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .kernels import nthash_scan, spaced_scan
from .models import bloom, kmer_bloom, mibf_construct
from .ops import nthash, nthash_tables, seeds


def bucket_length(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_codes(codes: np.ndarray, bucket: int) -> np.ndarray:
    out = np.full(bucket, nthash_tables.CODE_N, dtype=np.uint8)
    out[: len(codes)] = codes
    return out


class HashPipeline:
    """Frames (hashes [..., W, h]) of single reads or read lists, padded to
    length buckets and hashed on ``device``: ntHash by the ntHash kernel's
    hash mode, or, with ``seed_strings``, the spaced-seed stHash by the
    spaced-hash kernel (their plain versions on the CPU). With seeds, h is
    the total hash count, as in the reference: each seed gives m2 =
    max(1, h // len(seeds)) hashes, so a frame holds len(seeds) * m2."""

    def __init__(self, k: int, h: int, seed_strings: Tuple[str, ...] = (),
                 device="cuda"):
        self.k = k
        self.h = h
        self.seed_strings = tuple(seed_strings)
        self.device = torch.device(device)

    def _frames(self, codes: np.ndarray):
        codes = torch.from_numpy(codes).to(self.device)
        if self.seed_strings:
            m2 = max(1, self.h // len(self.seed_strings))
            planes, strand, valid = spaced_scan.spaced_frames_planes(
                codes, self.seed_strings, m2)
            return seeds.SpacedFrames(hashes=planes.movedim(0, -1),
                                      strand=strand.movedim(0, -1),
                                      valid=valid)
        planes, strand, valid = nthash_scan.hash_frames_planes(
            codes, self.k, self.h)
        return nthash.NtHashFrames(hashes=planes.movedim(0, -1),
                                   strand=strand, valid=valid)

    def frames(self, codes: np.ndarray):
        """Hash one sequence (1-D codes); trailing padded windows are
        invalid. None when the sequence is shorter than k."""
        if len(codes) < self.k:
            return None
        bucket = bucket_length(len(codes), max(64, self.k))
        f = self._frames(pad_codes(np.asarray(codes), bucket)[None])
        return dataclasses.replace(f, hashes=f.hashes[0],
                                   strand=f.strand[0], valid=f.valid[0])

    def frames_batch(self, codes_list):
        """Hash a list of sequences as one [R, bucket] batch padded to the
        bucket of the longest; short reads and padding hash invalid."""
        bucket = bucket_length(max(len(c) for c in codes_list),
                               max(64, self.k))
        return self._frames(np.stack([pad_codes(np.asarray(c), bucket)
                                      for c in codes_list]))


class BloomPipeline:
    """Hash + insert and hash + query of [B, L] code batches into one
    filter, which stays on its device and is updated in place."""

    def __init__(self, bf: bloom.BloomFilter):
        self.bf = bf

    def insert_batch(self, codes) -> None:
        kmer_bloom.insert_seq(self.bf, codes)

    def query_batch(self, codes):
        """(hit bool [B, W], valid bool [B, W]) on the filter's device."""
        return kmer_bloom.contains_seq(self.bf, codes)


class MIBFConstructPipeline:
    """The 4-phase MIBF build of one bit vector, on the state's device:
    phase 1 per sequence (``insert_bv_seq``), ``freeze``, then phases 3 and
    4 per sequence or per batch of sequences (``insert_mibf_seq`` /
    ``insert_mibf_batch``, ``insert_saturation_seq`` /
    ``insert_saturation_batch``; a batch equals its sequences one at a time
    in ID order). The filter ``m`` and its ``counts`` are updated in
    place."""

    def __init__(self, state: mibf_construct.BitVectorState):
        self.state = state
        self.hash = HashPipeline(state.kmer_size, state.hash_num,
                                 state.sseeds, device=state.bv_words.device)

    def insert_bv_seq(self, codes: np.ndarray) -> None:
        fr = self.hash.frames(codes)
        if fr is not None:
            mibf_construct.insert_bv(self.state, fr.hashes, fr.valid)

    def freeze(self, data_width: int = 2):
        self.m, self.counts = mibf_construct.get_empty_mibf(self.state,
                                                            data_width)
        return self.m

    def insert_mibf_seq(self, codes: np.ndarray, id_value: int) -> None:
        fr = self.hash.frames(codes)
        if fr is not None:
            mibf_construct.insert_mibf(self.m, self.counts, fr.hashes,
                                       id_value, fr.valid)

    def insert_mibf_batch(self, codes_list, ids) -> None:
        """Phase 3 for many sequences at once; reads shorter than k add
        nothing."""
        fr = self.hash.frames_batch(codes_list)
        mibf_construct.insert_mibf_many(self.m, self.counts, fr.hashes,
                                        list(ids), fr.valid)

    def insert_saturation_seq(self, codes: np.ndarray, id_value: int) -> None:
        fr = self.hash.frames(codes)
        if fr is not None:
            mibf_construct.insert_saturation(self.m, self.counts, fr.hashes,
                                             id_value, fr.valid)

    def insert_saturation_batch(self, codes_list, ids) -> None:
        fr = self.hash.frames_batch(codes_list)
        mibf_construct.insert_saturation_many(self.m, self.counts, fr.hashes,
                                              list(ids), fr.valid)
