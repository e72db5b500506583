"""Kernel times of one source tree of the port, for comparing two trees
(a parent commit and a change) on one GPU in one call.

    python btl_bloomfilter_tpu_torch/tools/time_kernels.py [--tree DIR]
        [--label NAME] [--kernels nthash_scan,scatter_or,...]

Imports ``btl_bloomfilter_tpu_torch`` from DIR (default: the tree this file
is in), builds its kernels, and prints one JSON line with the card, the
label and the milliseconds a call of each chosen kernel, timed by
``tools/timing.py`` as chip_smoke.py times: as the host issues the calls
(key ``name``) and with the calls queued, the card's own time (key ``name
queued``), and for a call that needs no setup the host's time to issue it
(key ``name host``). The kernels it can time (``CALLS``):

  * ``nthash_scan``: positions at chip_smoke.py's phase-2 shape (512 x 2048
    reads with 2% N, k=31, h=4, size 2**30), and at bench.py's ACGT batch
    of the same shape: positions, hashes, and positions at k=129;
  * ``nthash_scan_runs``: the ntHash kernel at each run length it takes
    (``nthash_scan.run_length``), positions of the ACGT batch at k from 31
    to 129 (h=4), and at k=1 (no roll-in) and h=1 (a quarter of the
    stores);
  * ``gather_words``: the Bloom query's gather at bench.py's batch into
    2**30 bits, on the inserted batch (every window hits) and on a fresh
    one (seed 1; slot 0 decides almost every miss); torch's
    ``words[idx]`` at the inserted batch's word indices (the same random
    loads through int64 indices, not the same function); and
    ``cudaLimitMaxL2FetchGranularity``;
  * ``bloom_steps``: the Bloom insert step from a zeroed filter and the
    query step of the inserted batch (``kmer_bloom``), bench.py's batch;
  * ``blocked``: the blocked filter at 2**30 bits, k=31, h=4, on bench.py's
    ACGT batch, the 2%-N batch and a poly-A batch (512 x 2048 each): the
    canonical-hash insert and ``blocked.insert_seq`` from zeroed rows (one
    call a repetition, 21 repetitions) and into rows already holding the
    batch, and ``contains`` of the inserted batch; the canonical-hash
    insert of the ACGT batch from zero also at h = 1, 2, 8 and 16;
  * ``counting_steps``: the counting insert step (ungrouped conservative
    update) from zeroed counters and the query step, bench.py's counting
    batch;
  * ``mibf_frame_scan``: pass C on the inputs bench.py's MIBF config gives
    it (``tools/profile_mibf.py``: 256 reads x 2048 bases, 2018 frames of 4
    slots);
  * ``mibf_rank``: the rank lookup, rank only at the build's positions and
    rank + ID at the classification's, at bench.py's MIBF config and at
    chip_smoke.py 7c's size (there also the width-8 form, uint64 IDs), and
    ``mibf.freeze`` at bench.py's config (``rank_calls``);
  * ``spaced_scan``: the spaced-seed hash with chip_smoke.py phase 10's
    two mirrored seeds of length 31, m2 = 2, at ``nthash_scan``'s 2%-N
    batch and at bench.py's ACGT batch;
  * ``mibf_random_insert``: MIBloomFilter::insert of 4096 random frames (h
    = 4, random strands, max_count 1) into an empty width-2 ID array over
    a random bit vector of chip_smoke.py 7c's 96,817,664 bits; each call
    first copies the 97 MB array back to zeros (about 0.06 ms of a call);
    and of 2**16 frames in three forms: random, a quarter of them
    duplicates at random places (phase 10c's mix), and every frame one
    k-mer (one chain as long as the batch), 3 calls a repetition, no host
    time;
  * ``dma_sweep``: each copy sweep of ``probes/partition_probe.py``, and
    ``copy_`` of the same tensor beside it;
  * ``scatter_or``: the Bloom insert at bench.py's batch (512 x 2048 ACGT
    reads, k=31, h=4: 4,132,864 positions into 2**30 bits), at
    ``nthash_scan``'s batch with 2% N (the same slots, about 53% of them
    live; the rest sentinels), and at MIBF
    phase 1's two shapes (bench.py's config: 4,121,208 positions into
    2**28 bits; chip_smoke.py's 7c: 1,048,456 into 96,817,664 bits, both
    uniform random positions as the hash gives them); the public wrapper,
    each route where the tree has them, and the whole insert
    step (``kmer_bloom.insert_seq``) at the bench batch;
  * ``scatter_add``: incrementAll at the counting bench batch (3072 x 2048
    ACGT reads: 24,792,576 unit adds into 2**30 u8 counters), the wrapper,
    each route, and ``counting.insert_all`` of the batch;
  * ``tile_partition``: the partition alone at those two bench batches
    (with ``--profile``, its device time by launch);
  * ``sorted_scatter``: the probes' sorted scatters at ``probes/
    ring_probe.py``'s step (bench.py's ACGT batch: 4,132,864 positions
    sorted, repeats set to the sentinel, into 2**30 bits): the probe's
    delta step (hash, sort, dedupe, delta form) and the delta form
    (``scatter_ring``, a new filter from a random one) alone, and the in
    place form (``scatter_or.scatter_or_sorted``, from a zeroed filter)
    beside it; both forms on 2**20 uniform positions into 2**24 bits,
    sorted and unsorted (the cost of order); and ``clone`` of the 128 MiB
    filter (the same bytes, not the same function);
  * ``block_sort``: ``vmem_sort.sort_blocks`` at ``probes/
    vmem_sort_probe.py``'s 4,194,304 keys and ``vmem_sort.chunk_bitonic``
    at ``probes/partition_probe.py``'s 4,194,304 keys, each beside
    ``torch.sort`` of the sign-flipped block view (the same blocks in the
    same order);
  * ``window_scatter``: the static-window scatter, scatter and null, at
    ``probes/kernel_lab.py``'s inputs (4 * 2**20 sorted positions, 2**30
    bits, 4 slots), and ``copy_`` of the 128 MiB filter;
  * ``scatter_or_grid``, ``scatter_add_grid``: each route of the two
    scatters over a grid of array words and uniform random positions, the
    data the route rules' constants come from;
  * ``scatter_or_wide_grid``, ``scatter_add_wide_grid``: the same past
    2**32 with wide (int64) uniform positions: the Bloom insert at 2**32,
    2**34, 2**35 and 59,427,361,984 bits (a human genome at write_bloom's
    -p 0.0001) with 1M to 26,863,616 positions (one and two h = 13
    batches), and unit adds into 2**32 u8 counters with 1M to 24,797,184
    pairs (bench.py's counting batch); each route the size allows (tiled
    up to the partition's MAX_TILES tiles, incrementAll's sparse route
    where the tree has it), and the route the rule takes;
  * ``access_rates``: the card's random 4-byte loads (``gather_words`` of
    one position a query) and atomicOrs (``scatter_or``'s direct route) of
    13,431,808 uniform int64 positions into arrays of 512 KiB (in L2), 128
    MiB, 2 GiB and 7.4 GB, in random and in address order (the positions
    sorted).

Every scatter is timed from a fixed start: its array is zeroed before each
repetition, outside the events (``timing.median_ms``'s ``setup``). With
``--profile`` each call's device time by kernel under ``torch.profiler``
(``tools/profile_mibf.py``'s ``profile``, 10 calls) joins the line, as
``name kernels``: [kernel, ms a call, launches a call].

Run it with the parent's tree and the change's in turns (parent, change,
change, parent) to compare the two on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_timing():
    """This tree's ``tools/timing.py``, loaded by path: the package is
    imported from --tree, which may be an older tree without it."""
    spec = importlib.util.spec_from_file_location(
        "_btl_time_kernels_timing", os.path.join(HERE, "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses looks the module up
    spec.loader.exec_module(mod)
    return mod


def acgt_codes(dev, rows: int = 512, seed: int = 0) -> torch.Tensor:
    """rows x 2048 ACGT reads, bench.py's codes for seed 0."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, size=(rows, 2048), dtype=np.uint8)).to(dev)


def n_codes(dev) -> torch.Tensor:
    """512 x 2048 reads with 2% N (chip_smoke.py phase 2's, seed 0)."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(512, 2048), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    return torch.from_numpy(codes).to(dev)


def hash_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan

    codes = n_codes(dev)
    acgt = acgt_codes(dev)
    return {"nthash_scan": lambda: nthash_scan.positions_planes(
                codes, 31, 4, 1 << 30),
            "nthash_scan acgt": lambda: nthash_scan.positions_planes(
                acgt, 31, 4, 1 << 30),
            "nthash_scan acgt hashes": lambda: nthash_scan.hash_frames_planes(
                acgt, 31, 4),
            "nthash_scan acgt k=129": lambda: nthash_scan.positions_planes(
                acgt, 129, 4, 1 << 30)}


def with_attr(mod, name: str, value, fn):
    """fn run with mod.name set to value."""
    def call():
        old = getattr(mod, name)
        setattr(mod, name, value)
        try:
            return fn()
        finally:
            setattr(mod, name, old)
    return call


def hash_run_calls(dev) -> dict:
    """The ntHash kernel at each run length it takes (trees that have
    ``nthash_scan.run_length``), positions of the ACGT batch at k from 31
    to 129 (h=4), and at k=1 (no roll-in) and h=1 (a quarter of the
    stores)."""
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan

    if not hasattr(nthash_scan, "run_length"):
        return {}
    acgt = acgt_codes(dev)
    return {f"nthash_scan acgt k={k} h={h} run {r}": with_attr(
        nthash_scan, "run_length", lambda _k, r=r: r,
        lambda k=k, h=h: nthash_scan.positions_planes(acgt, k, h, 1 << 30))
        for k, h in ((31, 4), (48, 4), (64, 4), (96, 4), (129, 4), (1, 4),
                     (31, 1))
        for r in (16, 32)}


def gather_calls(dev) -> dict:
    """The Bloom query's gather at bench.py's batch (512 x 2048 ACGT reads,
    k=31, h=4, 2**30 bits) on the inserted batch (every window hits) and on
    a fresh batch (slot 0 decides almost every miss); beside it torch's
    ``words[idx]`` at the inserted batch's 4,132,864 word indices: the same
    random loads (int64 indices, 8 B each), not the same function."""
    from btl_bloomfilter_tpu_torch.kernels import (_build, gather_words,
                                                   nthash_scan, scatter_or)

    pos = acgt_positions(dev, 512, 30)
    fresh = nthash_scan.positions_planes(acgt_codes(dev, seed=1), 31, 4,
                                         1 << 30)[0]
    words = torch.zeros(1 << 25, dtype=torch.int32, device=dev)
    scatter_or.scatter_or(words, pos)
    idx = (pos.to(torch.int64) & 0xFFFFFFFF) >> 5
    out = {"gather_words inserted": lambda: gather_words.gather_words(
               words, pos),
           "gather_words fresh": lambda: gather_words.gather_words(
               words, fresh),
           "words[idx] inserted": lambda: words[idx]}
    lib = _build.library()
    if hasattr(lib, "btl_l2_fetch_granularity"):
        lib.btl_l2_fetch_granularity.restype = ctypes.c_longlong
        out["cudaLimitMaxL2FetchGranularity"] = str(
            lib.btl_l2_fetch_granularity())
    return out


def bloom_step_calls(dev) -> dict:
    """The Bloom insert step (from a zeroed filter) and query step (of the
    inserted batch) at bench.py's batch, through ``kmer_bloom``."""
    from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom

    codes = acgt_codes(dev)
    bf = bloom.create(1 << 30, 4, 31, device=dev)
    query = bloom.create(1 << 30, 4, 31, device=dev)
    kmer_bloom.insert_seq(query, codes)
    return {"bloom insert step": (lambda: kmer_bloom.insert_seq(bf, codes),
                                  bf.words.zero_),
            "bloom query step": lambda: kmer_bloom.contains_seq(query,
                                                                codes)}


def blocked_calls(dev) -> dict:
    """The blocked filter at bench.py's config (2**30 bits, k=31, h=4) on
    three 512 x 2048 batches: bench.py's ACGT reads, ``nthash_scan``'s reads
    with 2% N and poly-A reads (every window one canonical hash). For each,
    the canonical-hash insert (``blocked_bloom.insert``, the hashes made
    once beforehand) and the sequence insert (``blocked.insert_seq``: hash
    and insert) from zeroed rows, one call a repetition (before each,
    outside the events, the rows are zeroed and then 96 MiB of other memory,
    so that no row is left in the 50 MB L2), and into rows that already
    hold the batch (warm: the batch's rows stay partly in L2 from call to
    call); and ``blocked_bloom.contains`` of the inserted batch. The
    canonical-hash insert of the ACGT batch from zero also at h = 1, 2, 8
    and 16 (the same rows, more bits a row)."""
    from btl_bloomfilter_tpu_torch.kernels import (blocked_bloom,
                                                   nthash_scan,
                                                   tile_partition)
    from btl_bloomfilter_tpu_torch.models import blocked

    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    bf = blocked.create(1 << 30, 4, 31, device=dev)

    def cold():
        bf.rows.zero_()
        flush.zero_()

    out = {}
    for label, codes in (
            ("acgt", acgt_codes(dev)),
            ("2% N", n_codes(dev)),
            ("poly-A", torch.zeros((512, 2048), dtype=torch.uint8,
                                   device=dev))):
        planes, _s, valid = nthash_scan.hash_frames_planes(codes, 31, 1)
        canon = planes[0].contiguous()
        full = blocked.create(1 << 30, 4, 31, device=dev)
        blocked.insert_seq(full, codes)
        out.update({
            f"blocked insert {label} from zero": (
                lambda c=canon, v=valid: blocked_bloom.insert(
                    bf.rows, c, 31, 4, v), cold, 1, 21),
            f"blocked insert {label} holding it": (
                lambda c=canon, v=valid, r=full.rows: blocked_bloom.insert(
                    r, c, 31, 4, v)),
            f"blocked insert_seq {label} from zero": (
                lambda c=codes: blocked.insert_seq(bf, c), cold, 1, 21),
            f"blocked insert_seq {label} holding it": (
                lambda f=full, c=codes: blocked.insert_seq(f, c)),
            f"blocked contains {label}": (
                lambda c=canon, v=valid, r=full.rows: blocked_bloom.contains(
                    r, c, 31, 4, v))})
        if label == "acgt":
            # the reductions a k-mer grow with h, its row does not
            out.update({f"blocked insert acgt h={h} from zero": (
                lambda c=canon, h=h: blocked_bloom.insert(bf.rows, c, 31,
                                                          h), cold, 1, 21)
                for h in (1, 2, 8, 16)})
            # address order: the hashes sorted by block, and the tile
            # partition of the k-mers by 64 KiB tile of rows (tile << 21 |
            # k-mer index, 2048 tiles)
            block = canon.reshape(-1).remainder(1 << 21)
            by_block = canon.reshape(-1)[torch.argsort(block)]
            keys = (block >> 10) << 21 | torch.arange(block.numel(),
                                                      device=dev)
            keys = torch.where(keys >= 1 << 31, keys - (1 << 32),
                               keys).to(torch.int32)     # uint32 bits
            out.update({
                "blocked insert acgt by block from zero": (
                    lambda: blocked_bloom.insert(bf.rows, by_block, 31, 4),
                    cold, 1, 21),
                "tile_partition acgt k-mers by row tile": (
                    lambda: tile_partition.tile_partition(keys, 2048 << 14,
                                                          7), None)})
    return out


def frame_scan_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import mibf_frame_scan
    from btl_bloomfilter_tpu_torch.tools import profile_mibf as mb

    refs, reads, _ = mb.bench_inputs()
    m, _ = mb.bench_build(torch.from_numpy(refs).to(dev),
                          torch.arange(1, mb.IDS, device=dev))
    qhashes, qvalid = mb.bench_hashes(torch.from_numpy(reads).to(dev))
    calls, scan = [], mibf_frame_scan.frame_scan

    def recorded(*a):
        calls.append(a)
        return scan(*a)

    mibf_frame_scan.frame_scan = recorded
    try:
        mb.bench_engine(m).query_many(qhashes, qvalid, mb.MIN_COUNT)
    finally:
        mibf_frame_scan.frame_scan = scan
    fargs = calls[0]
    return {"mibf_frame_scan": lambda: scan(*fargs)}


def rank_calls(dev) -> dict:
    """The MIBF rank lookup: rank only at the build's positions and rank +
    ID (width 2) at the classification's 2,066,432, at bench.py's config
    (``tools/profile_mibf.py``: 2**28 bits, 4,121,208 build positions) and
    at chip_smoke.py 7c's size (96,817,664 bits at occupancy 0.5, random
    words; 67,101,184 build positions, uniform as the hash gives them;
    there also rank + ID over a random uint64 ID plane, the width-8 form,
    in trees that have it); and ``mibf.freeze`` of bench.py's bit vector,
    which builds the rank structure the lookups read."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    from btl_bloomfilter_tpu_torch.models import mibf
    from btl_bloomfilter_tpu_torch.tools import profile_mibf as mb

    refs, reads, _ = mb.bench_inputs()
    bench, _ = mb.bench_build(torch.from_numpy(refs).to(dev),
                              torch.arange(1, mb.IDS, device=dev))
    bpos = mibf.positions(bench, mb.bench_hashes(
        torch.from_numpy(refs).to(dev))[0])
    qpos = mibf.positions(bench, mb.bench_hashes(
        torch.from_numpy(reads).to(dev))[0])
    size = 96817664
    words = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1 << 32, size=size // 32, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(dev)
    big = mibf.freeze(words, size, mb.H, mb.K, mb.DATA_WIDTH)
    big.data = torch.randint(-(1 << 15), 1 << 15, (big.d_size,),
                             dtype=torch.int16, device=dev)
    out = {"mibf freeze bench": lambda: mibf.freeze(
        bench.bv_words, bench.size, mb.H, mb.K, mb.DATA_WIDTH)}
    for label, m, build, query in (
            ("bench", bench, bpos, qpos),
            ("7c", big, uniform_positions(dev, 67101184, size),
             uniform_positions(dev, 2066432, size, seed=2))):
        # trees from before the rank directory take no rank_dir
        args = (m.bv_words, m.cum_ranks) + (
            (m.rank_dir,) if hasattr(m, "rank_dir") else ())
        out[f"mibf_rank {label} rank only {build.numel()}"] = (
            lambda a=args, p=build: mibf_rank.rank_lookup(*a, p))
        out[f"mibf_rank {label} rank + ID {query.numel()}"] = (
            lambda a=args, p=query, d=m.data: mibf_rank.rank_lookup(*a, p,
                                                                    d))
    if hasattr(mibf_rank, "U64_KERNEL"):
        q8 = uniform_positions(dev, 2066432, size, seed=2)
        data8 = torch.randint(-(1 << 63), (1 << 63) - 1, (big.d_size,),
                              dtype=torch.int64, device=dev)
        out[f"mibf_rank 7c rank + ID width 8 {q8.numel()}"] = (
            lambda p=q8, d=data8: mibf_rank.rank_lookup(
                big.bv_words, big.cum_ranks, big.rank_dir, p, d))
    return out


SPACED_SEEDS = ("1101111011111011111111011111111",
                "1111111101111111101111101111011")


def spaced_calls(dev) -> dict:
    try:
        from btl_bloomfilter_tpu_torch.kernels import spaced_scan
    except ImportError:
        return {"spaced_scan": "not in this tree"}
    nbatch = n_codes(dev)
    codes = acgt_codes(dev, 512)
    return {"spaced_scan": lambda: spaced_scan.spaced_frames_planes(
                nbatch, SPACED_SEEDS, 2),
            "spaced_scan acgt": lambda: spaced_scan.spaced_frames_planes(
                codes, SPACED_SEEDS, 2)}


def random_insert_calls(dev) -> dict:
    try:
        from btl_bloomfilter_tpu_torch.kernels import mibf_random_insert
    except ImportError:
        return {"mibf_random_insert": "not in this tree"}
    from btl_bloomfilter_tpu_torch.models import mibf
    from btl_bloomfilter_tpu_torch.ops import u64

    size = 96817664
    rng = np.random.default_rng(11)
    words = torch.from_numpy(rng.integers(
        0, 1 << 32, size=size // 32, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(dev)
    m = mibf.freeze(words, size, 4, 31, 2)
    hashes = u64.from_numpy(rng.integers(0, 1 << 64, size=(4096, 4),
                                         dtype=np.uint64)).to(dev)
    strand = torch.from_numpy(rng.random((4096, 4)) < 0.5).to(dev)
    zero = torch.zeros_like(m.data)

    def call():
        m.data.copy_(zero)
        return mibf_random_insert.random_insert(
            m.bv_words, m.cum_ranks, m.rank_dir, m.data, hashes, size, 7, 1,
            strand)

    def frames(hs, st):
        def run():
            m.data.copy_(zero)
            return mibf_random_insert.random_insert(
                m.bv_words, m.cum_ranks, m.rank_dir, m.data, hs, size, 7, 1,
                st)
        # the copy as setup too: no host time (a call takes up to a
        # fifth of a second on the one-thread walk), 3 calls a repetition
        return run, run, 3

    n = 1 << 16
    hs = u64.from_numpy(rng.integers(0, 1 << 64, size=(n, 4),
                                     dtype=np.uint64)).to(dev)
    st = torch.from_numpy(rng.random((n, 4)) < 0.5).to(dev)
    # a quarter of the frames repeat one of the first three quarters, at
    # random places (chip_smoke.py phase 10c's mix)
    dup = np.concatenate([np.arange(3 * n // 4),
                          rng.integers(0, 3 * n // 4, size=n // 4)])
    dup = torch.from_numpy(rng.permutation(dup)).to(dev)
    return {"mibf_random_insert 4096 frames": call,
            "mibf_random_insert 65536 random frames": frames(hs, st),
            "mibf_random_insert 65536 frames, a quarter duplicates":
                frames(hs[dup].contiguous(), st[dup].contiguous()),
            "mibf_random_insert 65536 frames of one k-mer":
                frames(hs[:1].expand(n, 4).contiguous(),
                       st[:1].expand(n, 4).contiguous())}


def sweep_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.probes import partition_probe

    out = {}
    for k, rows in partition_probe.SWEEPS:
        copy, src = partition_probe.dma_sweep(partition_probe.NSTEPS, k,
                                              rows, device=dev)
        dst = torch.empty_like(src)
        out[f"dma_sweep {k}x{rows}"] = lambda c=copy, s=src: c(s)
        out[f"copy_ {k}x{rows}"] = lambda d=dst, s=src: d.copy_(s)
    return out


def acgt_positions(dev, rows: int, log2_bits: int) -> torch.Tensor:
    """Positions int32 [4, rows, 2018] of rows x 2048 ACGT reads (bench.py's
    codes, seed 0), k=31, h=4, into 2**log2_bits counters or bits."""
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan

    pos, _s, _v = nthash_scan.positions_planes(acgt_codes(dev, rows), 31, 4,
                                               1 << log2_bits)
    return pos


def uniform_positions(dev, n: int, limit: int, seed: int = 1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, limit, size=n, dtype=np.int64).astype(np.uint32)
        .view(np.int32)).to(dev)


def route_calls(label: str, words: torch.Tensor, pos: torch.Tensor,
                kind: str, public: bool = True) -> dict:
    """The public wrapper and, where the tree has them, each route of the
    Bloom insert (kind "or") or the unit add into u8 counters (kind "add"),
    each as (call, setup) from zeroed words, and the route the rule
    takes."""
    from btl_bloomfilter_tpu_torch.kernels import scatter_add, scatter_or

    mod = scatter_or if kind == "or" else scatter_add
    args = () if kind == "or" else (2, 255)
    name = "scatter_or" if kind == "or" else "scatter_add"
    zero = words.zero_
    out = {}
    if public:
        out[f"{name} {label}"] = (
            lambda: getattr(mod, name)(words, pos, *args), zero)
    if hasattr(mod, f"{name}_tiled"):
        direct, tiled = getattr(mod, f"{name}_direct"), getattr(
            mod, f"{name}_tiled")
        out[f"{name} {label} direct"] = (lambda: direct(words, pos, *args),
                                         zero)
        out[f"{name} {label} tiled"] = (lambda: tiled(words, pos, *args),
                                        zero)
        out[f"{name} {label} route"] = mod.route(words.numel(), pos.numel())
    return out


def scatter_or_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom

    out = {}
    for label, words, pos in (
            ("bloom", torch.zeros(1 << 25, dtype=torch.int32, device=dev),
             acgt_positions(dev, 512, 30)),
            ("bloom 2% N", torch.zeros(1 << 25, dtype=torch.int32,
                                       device=dev),
             hash_calls(dev)["nthash_scan"]()[0]),
            ("mibf 7b", torch.zeros(1 << 23, dtype=torch.int32, device=dev),
             uniform_positions(dev, 63 * (16384 - 30) * 4, 1 << 28)),
            ("mibf 7c", torch.zeros(96817664 // 32, dtype=torch.int32,
                                    device=dev),
             uniform_positions(dev, (262144 - 30) * 4, 96817664))):
        out.update(route_calls(label, words, pos, "or"))
    codes = acgt_codes(dev)
    bf = bloom.create(1 << 30, 4, 31, device=dev)
    out["bloom insert step"] = (lambda: kmer_bloom.insert_seq(bf, codes),
                                bf.words.zero_)
    return out


def scatter_add_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan
    from btl_bloomfilter_tpu_torch.models import counting

    words = torch.zeros(1 << 28, dtype=torch.int32, device=dev)
    out = route_calls("counting", words, acgt_positions(dev, 3072, 30),
                      "add")
    codes = acgt_codes(dev, 3072)
    hashes, _s, valid = nthash_scan.hash_frames_planes(codes, 31, 4)
    hashes = hashes.movedim(0, -1)
    cbf = counting.create(1 << 30, 4, 31, 1, counter_width=1, device=dev)
    out["counting insert_all"] = (
        lambda: counting.insert_all(cbf, hashes, valid), cbf.counters.zero_)
    return out


def counting_step_calls(dev) -> dict:
    """The counting insert step (conservative update, ungrouped) from zeroed
    counters and the query step of the inserted batch, at bench.py's
    counting batch (3072 x 2048 ACGT reads, 2**30 u8 counters)."""
    from btl_bloomfilter_tpu_torch.models import counting

    codes = acgt_codes(dev, 3072)
    cbf = counting.create(1 << 30, 4, 31, 1, counter_width=1, device=dev)
    query = counting.create(1 << 30, 4, 31, 1, counter_width=1, device=dev)
    counting.insert_seq(query, codes, group_duplicates=False)
    return {"counting insert step": (
                lambda: counting.insert_seq(cbf, codes,
                                            group_duplicates=False),
                cbf.counters.zero_),
            "counting query step": lambda: counting.contains_seq(query,
                                                                 codes)}


def partition_calls(dev) -> dict:
    try:
        from btl_bloomfilter_tpu_torch.kernels import tile_partition
    except ImportError:         # a tree from before the partition
        return {}
    out = {}
    for label, pos, nwords, shift in (
            ("bloom", acgt_positions(dev, 512, 30), 1 << 25, 5),
            ("counting", acgt_positions(dev, 3072, 30), 1 << 28, 2)):
        out[f"tile_partition {label}"] = (
            lambda p=pos, w=nwords, s=shift: tile_partition.tile_partition(
                p, w, s), None)
    return out


def sorted_scatter_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import scatter_or, scatter_ring
    from btl_bloomfilter_tpu_torch.probes import ring_probe

    codes = acgt_codes(dev)
    pos_d, _ = ring_probe.sorted_positions(codes, 1 << 30)
    start = torch.from_numpy(np.random.default_rng(3).integers(
        0, 1 << 32, size=1 << 25, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)).to(dev)
    zeros = torch.zeros_like(start)
    small = start[: 1 << 19]
    small0 = torch.zeros_like(small)
    uni = uniform_positions(dev, 1 << 20, 1 << 24)
    uni_s = torch.sort(uni.to(torch.int64) & 0xFFFFFFFF).values.to(
        torch.int32)
    delta_step = ring_probe.make_step(scatter_ring.scatter_or_sorted,
                                      1 << 30)
    return {"ring probe delta step": lambda: delta_step(start, codes),
            "scatter_or_sorted_delta ring": lambda: scatter_ring.
            scatter_or_sorted(start, pos_d),
            "scatter_or_sorted ring": (lambda: scatter_or.scatter_or_sorted(
                zeros, pos_d), zeros.zero_),
            "scatter_or_sorted_delta 2**24 sorted": lambda: scatter_ring.
            scatter_or_sorted(small, uni_s),
            "scatter_or_sorted_delta 2**24 unsorted": lambda: scatter_ring.
            scatter_or_sorted(small, uni),
            "scatter_or_sorted 2**24 sorted": (
                lambda: scatter_or.scatter_or_sorted(small0, uni_s),
                small0.zero_),
            "scatter_or_sorted 2**24 unsorted": (
                lambda: scatter_or.scatter_or_sorted(small0, uni),
                small0.zero_),
            "clone 2**30 bits": start.clone}


def block_sort_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import vmem_sort
    from btl_bloomfilter_tpu_torch.probes import (partition_probe,
                                                  vmem_sort_probe)

    out = {}
    for name, x, block in (
            ("sort_blocks", vmem_sort_probe.make_keys(device=dev),
             vmem_sort.BLOCK),
            ("chunk_bitonic", partition_probe.make_keys(device=dev),
             vmem_sort.CHUNK)):
        flipped = (x ^ vmem_sort.SIGN).reshape(-1, block)
        out[name] = lambda f=getattr(vmem_sort, name), x=x: f(x)
        out[f"torch.sort {block}-key blocks"] = (
            lambda f=flipped: torch.sort(f, dim=-1))
    return out


def window_scatter_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import window_scatter
    from btl_bloomfilter_tpu_torch.probes import kernel_lab

    idx, pos, words = kernel_lab.make_inputs(device=dev)
    dst = torch.empty_like(words)
    return {"window_scatter scatter": lambda: window_scatter.window_scatter(
                idx, pos, words),
            "window_scatter null": lambda: window_scatter.window_scatter(
                idx, pos, words, False),
            "copy_ 2**30 bits": lambda: dst.copy_(words)}


def wide_uniform(dev, n: int, limit: int, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, limit, size=n, dtype=np.int64)).to(dev)


GENOME_BITS = 59_427_361_984
WIDE_GRID_BITS = (1 << 32, 1 << 34, 1 << 35, GENOME_BITS)
WIDE_GRID_POS = (1 << 20, 2 << 20, 4 << 20, 6 << 20, 8 << 20, 13_431_808,
                 2 * 13_431_808)
WIDE_ADD_POS = (1 << 20, 2 << 20, 4 << 20, 6 << 20, 8 << 20, 12 << 20,
                16 << 20, 24_797_184)


def wide_grid_calls(dev, kind: str) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import (scatter_add, scatter_or,
                                                   tile_partition)

    out = {}
    if kind == "or":
        shapes = [(-(-bits // 32), npos, f"{bits}b {npos}p")
                  for bits in WIDE_GRID_BITS for npos in WIDE_GRID_POS]
        mod, name, args, per = scatter_or, "scatter_or", (), 32
    else:
        shapes = [(1 << 30, npos, f"2**32 u8 {npos}p")
                  for npos in WIDE_ADD_POS]
        mod, name, args, per = scatter_add, "scatter_add", (2, 255), 4
    arrays = {}
    for nwords, npos, label in shapes:
        if nwords not in arrays:
            arrays[nwords] = torch.zeros(nwords, dtype=torch.int32,
                                         device=dev)
        words = arrays[nwords]
        pos = wide_uniform(dev, npos, nwords * per, seed=npos)
        routes = ["direct"]
        if kind == "or" and tile_partition.ntiles(nwords) <= \
                tile_partition.MAX_TILES:
            routes.append("tiled")
        if hasattr(mod, f"{name}_sparse"):
            routes.append("sparse")
        for r in routes:
            out[f"{name} {label} {r}"] = (
                lambda f=getattr(mod, f"{name}_{r}"), w=words, p=pos:
                f(w, p, *args), words.zero_)
        out[f"{name} {label} route"] = (
            mod.route(nwords, npos) if kind == "or"
            else mod.route(nwords, npos, wide=True))
    return out


RATE_BYTES = (512 << 10, 128 << 20, 2 << 30, GENOME_BITS // 8)
RATE_POS = 13_431_808


def rate_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import gather_words, scatter_or

    out = {}
    for nbytes in RATE_BYTES:
        words = torch.zeros(nbytes // 4, dtype=torch.int32, device=dev)
        pos = wide_uniform(dev, RATE_POS, nbytes * 8, seed=nbytes % 997)
        for order, p in (("random", pos), ("sorted", torch.sort(pos)[0])):
            label = f"{nbytes}B {RATE_POS}p {order}"
            out[f"load {label}"] = (
                lambda w=words, q=p[None]: gather_words.gather_words(w, q))
            out[f"atomicOr {label}"] = (
                lambda w=words, q=p: scatter_or.scatter_or_direct(w, q),
                words.zero_)
    return out


GRID_WORDS = [1 << e for e in range(20, 29)]
GRID_POS = [1 << 16, 1 << 18, 1 << 20, 3 << 19, 2 << 20, 3 << 20, 1 << 22,
            1 << 24]


def grid_calls(dev, kind: str) -> dict:
    out = {}
    words = torch.zeros(GRID_WORDS[-1], dtype=torch.int32, device=dev)
    per = 32 if kind == "or" else 4
    for npos in GRID_POS:
        for nwords in GRID_WORDS:
            if nwords * per > 1 << 32:      # past uint32 positions
                continue
            pos = uniform_positions(dev, npos, nwords * per, seed=npos)
            out.update(route_calls(f"{nwords}w {npos}p", words[:nwords], pos,
                                   kind, public=False))
    return out


# kernel name -> the calls that time it, {label: call or (call, setup[,
# inner[, reps]])};
# a str value is recorded as it is
CALLS = {"nthash_scan": hash_calls, "nthash_scan_runs": hash_run_calls,
         "gather_words": gather_calls, "bloom_steps": bloom_step_calls,
         "blocked": blocked_calls,
         "counting_steps": counting_step_calls,
         "mibf_frame_scan": frame_scan_calls, "mibf_rank": rank_calls,
         "spaced_scan": spaced_calls,
         "mibf_random_insert": random_insert_calls,
         "dma_sweep": sweep_calls, "scatter_or": scatter_or_calls,
         "scatter_add": scatter_add_calls, "tile_partition": partition_calls,
         "sorted_scatter": sorted_scatter_calls,
         "block_sort": block_sort_calls,
         "window_scatter": window_scatter_calls,
         "scatter_or_grid": lambda dev: grid_calls(dev, "or"),
         "scatter_add_grid": lambda dev: grid_calls(dev, "add"),
         "scatter_or_wide_grid": lambda dev: wide_grid_calls(dev, "or"),
         "scatter_add_wide_grid": lambda dev: wide_grid_calls(dev, "add"),
         "access_rates": rate_calls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(
        k for k in CALLS if not k.endswith("_grid")
        and k != "access_rates"),
                    help="comma-separated, of: " + ", ".join(CALLS))
    ap.add_argument("--profile", action="store_true",
                    help="add each call's device time by kernel")
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    unknown = [n for n in names if n not in CALLS]
    if unknown:
        ap.error(f"no timing for {unknown}; known: {list(CALLS)}")
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA GPU")
    timing = load_timing()
    sys.path.insert(0, os.path.abspath(args.tree))
    from btl_bloomfilter_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "tree": args.tree, "card": card}
    torch.cuda._sleep(timing.QUEUE_CYCLES * 20)  # the card at its clocks
    for name in names:
        for label, call in CALLS[name](dev).items():
            if isinstance(call, str):
                out[label] = call
                continue
            fn, setup, *more = call if isinstance(call, tuple) \
                else (call, None)
            inner, reps = (more + [timing.INNER, timing.REPS][len(more):])
            t = timing.kernel_times(fn, reps, inner, setup=setup)
            out[label], out[label + " queued"] = t.issued, t.card
            if setup is None:
                out[label + " host"] = timing.host_ms(fn)
            if args.profile:
                from btl_bloomfilter_tpu_torch.tools.profile_mibf import \
                    profile
                if setup is not None:
                    setup()
                out[label + " kernels"] = profile(fn, 10)[2]
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
