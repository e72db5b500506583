"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and edge-case shapes (chip_smoke.py covers the bench shape).

Marked ``cuda``: each test skips when no CUDA device is present. This file
imports neither jax nor the JAX package, so it runs on a machine without
them; from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

All outputs are integers or bools: the tolerance is zero.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu_torch import kernels
from btl_bloomfilter_tpu_torch.kernels import (blocked_bloom,
                                               conservative_step,
                                               gather_counters, gather_words,
                                               nthash_scan, scatter_add,
                                               scatter_or, tile_partition)
from btl_bloomfilter_tpu_torch.models import (blocked, bloom, counting,
                                              kmer_bloom)
from btl_bloomfilter_tpu_torch.ops import u64
from btl_bloomfilter_tpu_torch.probes import partition_probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def random_codes(B, L, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < nfrac] = 4
    codes[rng.random((B, L)) < nfrac / 4] = 200      # other non-ACGT codes
    return torch.from_numpy(codes)


SHAPES = [  # B, L, k, h, nfrac, size
    (1, 31, 31, 1, 0.0, 1000),
    (3, 300, 2, 3, 0.1, 1 << 20),
    (5, 1000, 128, 2, 0.02, (1 << 32) - 1),
    (7, 513, 64, 5, 0.3, 3),
    (2, 257, 33, 4, 0.0, 1),
    (4, 2048, 31, 4, 0.02, (1 << 32) - 64),
    (3, 300, 1, 3, 0.1, 1 << 20),              # k == 1
    (4, 700, 129, 4, 0.002, (1 << 32) - 64),   # two pieces of the tables
    (3, 1500, 1024, 2, 0.0002, 1000),          # past srol's period of 1023
    (2, 1400, 1025, 3, 0.0002, 3),
]


@pytest.mark.parametrize("B,L,k,h,nfrac,size", SHAPES)
def test_nthash_kernel_matches_plain(dev, B, L, k, h, nfrac, size):
    codes = random_codes(B, L, nfrac, B * L + k).to(dev)
    for kernel, plain in [
            (lambda: nthash_scan.positions_planes(codes, k, h, size),
             lambda: nthash_scan.positions_planes_plain(codes, k, h, size)),
            (lambda: nthash_scan.hash_frames_planes(codes, k, h),
             lambda: nthash_scan.hash_frames_planes_plain(codes, k, h))]:
        before = nthash_scan.KERNEL.launches
        got = kernel()
        assert nthash_scan.KERNEL.launches == before + 1
        for a, b in zip(got, plain()):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("nwords", [1, 37, 1 << 20])
def test_scatter_or_kernel_matches_plain(dev, nwords):
    rng = np.random.default_rng(nwords)
    n = 50_000
    # positions inside and past the filter, duplicates and sentinels
    pos = rng.integers(0, nwords * 32 + 64, size=n, dtype=np.uint64)
    pos[rng.random(n) < 0.1] = 0xFFFFFFFF
    pos = np.concatenate([pos, pos[:1000]]).astype(np.uint32)
    pos = torch.from_numpy(pos.view(np.int32)).to(dev)
    start = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=nwords, dtype=np.int64).astype(np.int32)
        & 0x01010101).to(dev)
    got = scatter_or.scatter_or(start.clone(), pos)
    ref = scatter_or.scatter_or_plain(start.clone(), pos)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("h", [1, 4, 7])
def test_gather_words_kernel_matches_plain(dev, h):
    rng = np.random.default_rng(h)
    nwords = 1000
    words = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=nwords, dtype=np.int64).astype(np.int32)
        | 0x55555555).to(dev)
    pos = rng.integers(0, nwords * 32 + 500, size=(h, 6, 333),
                       dtype=np.uint64)
    pos[:, rng.random((6, 333)) < 0.1] = 0xFFFFFFFF   # invalid windows
    pos[rng.random((h, 6, 333)) < 0.02] = 0xFFFFFFFF  # stray sentinels
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    got = gather_words.gather_words(words, pos)
    ref = gather_words.gather_words_plain(words, pos)
    assert got.shape == (6, 333) and got.any() and torch.equal(got, ref)


ROLL_K = [1, 2, 31, 32, 33, 63, 64, 128, 129, 1023, 1024, 1025]
ROLL_SIZES = [1, 3, 1 << 30, (1 << 32) - 64]


def run_edge_codes(B, L, k, run, seed):
    """Codes with 2% N (and other non-ACGT codes), plus an N at the first
    and the last base of a run and at the base a run's last step takes in."""
    codes = random_codes(B, L, 0.02, seed)
    W = L - k + 1
    if W > run:
        codes[0, run] = 4
        codes[1 % B, run - 1] = 4
        codes[2 % B, run - 1 + k] = 200
    return codes


def check_nthash_modes(codes, k, h, size):
    for kernel, plain in [
            (lambda: nthash_scan.positions_planes(codes, k, h, size),
             lambda: nthash_scan.positions_planes_plain(codes, k, h, size)),
            (lambda: nthash_scan.hash_frames_planes(codes, k, h),
             lambda: nthash_scan.hash_frames_planes_plain(codes, k, h))]:
        before = nthash_scan.KERNEL.launches
        got = kernel()
        assert nthash_scan.KERNEL.launches == before + 1
        for a, b in zip(got, plain()):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("run", [16, 32])
@pytest.mark.parametrize("size", ROLL_SIZES)
@pytest.mark.parametrize("k", ROLL_K)
def test_nthash_roll_matches_plain(dev, monkeypatch, k, size, run):
    """Both modes, bitwise: W = 2 * run + 3 windows a read (not a multiple
    of the run) with Ns at the runs' edges, and W spanning two tiles."""
    monkeypatch.setattr(nthash_scan, "run_length", lambda k: run)
    codes = run_edge_codes(3, k + 2 * run + 2, k, run, k + run).to(dev)
    check_nthash_modes(codes, k, 3, size)
    codes = run_edge_codes(2, k + nthash_scan.TILE + 5, k, run, k).to(dev)
    check_nthash_modes(codes, k, 2, size)


@pytest.mark.parametrize("run", [16, 32])
@pytest.mark.parametrize("k,L", [(31, 31), (31, 33), (129, 129),
                                 (129, 135), (1, 1), (1, 3), (1025, 1027)])
def test_nthash_short_reads_match_plain(dev, monkeypatch, k, L, run):
    """L == k (one window) and fewer windows than a run."""
    monkeypatch.setattr(nthash_scan, "run_length", lambda k: run)
    check_nthash_modes(run_edge_codes(5, L, k, run, L).to(dev), k, 4,
                       (1 << 32) - 64)


def test_launch_error_raises_and_is_not_counted(dev):
    """A launch the runtime refuses (a grid of 2**31 blocks) raises with the
    CUDA error, leaves the counter alone, and the next launch counts."""
    before = nthash_scan.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        nthash_scan.KERNEL.launch(
            dev, 0, 1 << 31, 31, 31, 4, 1, 1 << 30, 0, 0, 16,
            ctypes.addressof(nthash_scan.roll_tables(31)), 0, 0, 0)
    assert nthash_scan.KERNEL.launches == before
    codes = random_codes(2, 100, 0.02, 1).to(dev)
    nthash_scan.positions_planes(codes, 31, 4, 1 << 30)
    assert nthash_scan.KERNEL.launches == before + 1
    torch.cuda.synchronize()


def gather_case(rng, h, nwords, shape, kind):
    """words int32 [nwords] and positions int32 [h, *shape] for a query
    kind: "hit" (every bit set), "miss" (slot 0 clear), "mixed" (random
    words, positions past the filter, slot-0 and stray sentinels)."""
    if kind == "hit":
        words = np.full(nwords, -1, dtype=np.int32)
    else:
        words = (rng.integers(-(1 << 31), 1 << 31, size=nwords,
                              dtype=np.int64) | 0x55555555).astype(np.int32)
    pos = rng.integers(0, nwords * 32 + (500 if kind == "mixed" else 0),
                       size=(h,) + shape, dtype=np.uint64)
    if kind == "miss":      # odd bits of a 0x55555555 pattern are clear
        words[:] = 0x55555555
        pos[0] |= 1
    if kind == "mixed":
        pos[:, rng.random(shape) < 0.1] = 0xFFFFFFFF    # slot-0 sentinels
        pos[rng.random((h,) + shape) < 0.05] = 0xFFFFFFFF  # stray ones
    return (torch.from_numpy(words),
            torch.from_numpy(pos.astype(np.uint32).view(np.int32)))


@pytest.mark.parametrize("kind", ["hit", "miss", "mixed"])
@pytest.mark.parametrize("n", [4096, 4099, 3])
@pytest.mark.parametrize("h", [1, 4, 7, 8, 9, 17])
def test_gather_words_edges_match_plain(dev, h, n, kind):
    """Every window hits, slot 0 always misses, or random words with
    slot-0 and stray sentinels and positions past the filter; h from 1 to
    17; n a multiple of 4 and not; the planes as an unaligned view; one
    launch a call."""
    rng = np.random.default_rng(h * 1000 + n)
    words, pos = gather_case(rng, h, 1000, (n,), kind)
    words, pos = words.to(dev), pos.to(dev)
    before = gather_words.KERNEL.launches
    got = gather_words.gather_words(words, pos)
    assert gather_words.KERNEL.launches == before + 1
    ref = gather_words.gather_words_plain(words, pos)
    assert got.shape == (n,) and torch.equal(got, ref)
    if kind == "hit":
        assert got.all()
    if kind == "miss":
        assert not got.any()
    flat = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      pos.reshape(-1)])[1:].view(pos.shape)
    assert torch.equal(gather_words.gather_words(words, flat), ref)


def test_kmer_bloom_on_cuda_matches_cpu(dev):
    codes = random_codes(16, 700, 0.02, 5)
    size, h, k = 1_000_000, 4, 25
    kernels.reset_launch_counts()
    bf_gpu = kmer_bloom.insert_seq(bloom.create(size, h, k, device=dev),
                                   codes)
    bf_cpu = kmer_bloom.insert_seq(bloom.create(size, h, k, device="cpu"),
                                   codes)
    assert torch.equal(bf_gpu.words.cpu(), bf_cpu.words)
    probe = torch.cat([codes[:8], random_codes(8, 700, 0.02, 6)])
    hit_g, valid_g = kmer_bloom.contains_seq(bf_gpu, probe)
    hit_c, valid_c = kmer_bloom.contains_seq(bf_cpu, probe)
    assert torch.equal(hit_g.cpu(), hit_c) and torch.equal(valid_g.cpu(),
                                                           valid_c)
    kmers = probe[:, :k]
    assert torch.equal(kmer_bloom.contains_kmers(bf_gpu, kmers).cpu(),
                       kmer_bloom.contains_kmers(bf_cpu, kmers))
    counts = kernels.launch_counts()
    # a 1,000,000-bit filter takes the direct route
    assert counts["nthash_scan"] == 3 and counts["scatter_or"] == 1
    assert counts["scatter_or_tiled"] == counts["tile_partition"] == 0
    assert counts["gather_words"] == 2


def test_wrappers_refuse_mixed_devices(dev):
    words = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        scatter_or.scatter_or(words, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_words.gather_words(words, torch.zeros(
            (2, 4), dtype=torch.int16, device=dev))


def random_words(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=n,
                                         dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("nwords", [1, 37, 1 << 18])
def test_gather_counters_kernel_matches_plain(dev, shift, nwords):
    rng = np.random.default_rng(nwords + shift)
    words = random_words(nwords, shift).to(dev)
    ncounters = nwords << shift
    # positions inside and past the counters, invalid windows, stray
    # sentinels
    pos = rng.integers(0, ncounters + 50, size=(4, 5, 777), dtype=np.uint64)
    pos[:, rng.random((5, 777)) < 0.1] = 0xFFFFFFFF
    pos[rng.random((4, 5, 777)) < 0.02] = 0xFFFFFFFF
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    before = gather_counters.KERNEL.launches
    for out, thr in (("vals", 0), ("min", 0), ("hit", 0), ("hit", 100),
                     ("hit", (1 << 32) + 5)):
        got = gather_counters.gather_counters(words, pos, shift, out, thr)
        ref = gather_counters.gather_counters_plain(words, pos, shift, out,
                                                    thr)
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert gather_counters.KERNEL.launches == before + 5


@pytest.mark.parametrize("h", [1, 4, 7, 8, 9, 11, 17])
def test_gather_counters_load_groups_match_plain(dev, h):
    """Every mode gives the plain result for h below, at and above the
    kernel's group of 8 loads, hit mode's lone first load included."""
    rng = np.random.default_rng(h)
    nwords, shift = 4096, 2
    words = random_words(nwords, h).to(dev)
    pos = rng.integers(0, (nwords << shift) + 50, size=(h, 3, 5000),
                       dtype=np.uint64)
    pos[:, rng.random((3, 5000)) < 0.1] = 0xFFFFFFFF
    pos[rng.random((h, 3, 5000)) < 0.02] = 0xFFFFFFFF
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    for out, thr in (("vals", 0), ("min", 0), ("hit", 60), ("hit", 200)):
        got = gather_counters.gather_counters(words, pos, shift, out, thr)
        assert torch.equal(got, gather_counters.gather_counters_plain(
            words, pos, shift, out, thr))


def disjoint_frames(rng, ncount, h, m):
    """Position-disjoint frames uint32 [h, m]: a live frame owns 1..h
    counters and repeats some of them in its other slots (in-frame
    duplicates, slots shuffled); a dead frame, or one past the counters,
    holds the sentinel in every slot."""
    k = rng.integers(1, min(h, ncount) + 1, size=m)
    k[rng.random(m) >= 0.8] = 0
    k[np.cumsum(k) > ncount] = 0
    live = k > 0
    own = rng.permutation(ncount)[:int(k.sum())]
    start = np.cumsum(k) - k
    j = np.arange(h)[None, :]
    extra = (rng.random((m, h)) * np.maximum(k, 1)[:, None]).astype(np.int64)
    pick = np.where(j < k[:, None], j, extra)
    pick = np.take_along_axis(pick, np.argsort(rng.random((m, h)), axis=1),
                              axis=1)
    pos = own[np.minimum(start[:, None] + pick, len(own) - 1)]
    return np.where(live[:, None], pos, 0xFFFFFFFF).astype(np.uint32).T, live


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("nwords", [1, 37, 1 << 18])
@pytest.mark.parametrize("h", [1, 4, 7, 11])
def test_conservative_step_kernel_matches_plain(dev, shift, nwords, h):
    """Position-disjoint frames with in-frame duplicates and sentinel
    frames, repeat counts from 1 to past the headroom, words preloaded with
    frozen and nearly full counters (h = 11 runs the scratch loop)."""
    rng = np.random.default_rng(nwords * 7 + shift * 3 + h)
    bits = 32 >> shift
    cmax = (1 << bits) - 1
    ncount = nwords << shift
    m = 30_000
    pos, live = disjoint_frames(rng, ncount, h, m)
    vals = rng.integers(0, cmax + 1, size=ncount, dtype=np.uint64)
    hot = pos[:, rng.random(m) < 0.3]
    hot = hot[hot != 0xFFFFFFFF]
    vals[hot] = cmax - rng.integers(0, 3, size=hot.size)
    lane = {0: "<u4", 1: "<u2", 2: "<u1"}[shift]
    words = torch.from_numpy(vals.astype(lane).view("<i4")
                             .astype(np.int32)).to(dev)
    c = rng.choice(np.array([1, 1, 2, 5, 255, 300, 65535, 1 << 20,
                             (1 << 32) + 3], np.int64), size=m)
    pos_t = torch.from_numpy(pos.view(np.int32)).to(dev)
    c_t = torch.from_numpy(c).to(dev)
    for cc in (c_t, torch.ones_like(c_t)):
        before = conservative_step.KERNEL.launches
        got = conservative_step.conservative_step(words.clone(), pos_t, cc,
                                                  shift, cmax)
        assert conservative_step.KERNEL.launches == before + 1
        ref = conservative_step.conservative_step_plain(words.clone(), pos_t,
                                                        cc, shift, cmax)
        assert torch.equal(got, ref)
        assert live.any() and not torch.equal(got, words)


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("nwords", [1, 37, 1 << 18])
def test_scatter_add_kernel_matches_plain(dev, shift, nwords):
    rng = np.random.default_rng(nwords * 3 + shift)
    cmax = (1 << (32 >> shift)) - 1
    start = random_words(nwords, nwords).to(dev)
    n = 60_000
    pos = rng.integers(0, (nwords << shift) + 64, size=n, dtype=np.uint64)
    pos[:2000] = pos[0]                         # a hot counter saturates
    pos[rng.random(n) < 0.05] = 0xFFFFFFFF
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    # full uint32 increments, zeros among them
    inc = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    inc[rng.random(n) < 0.3] = rng.integers(0, 4, size=1)[0]
    inc = torch.from_numpy(inc.astype(np.uint32).view(np.int32)).to(dev)
    for c in (None, inc):
        got = scatter_add.scatter_add(start.clone(), pos, shift, cmax, c)
        ref = scatter_add.scatter_add_plain(start.clone(), pos, shift, cmax,
                                            c)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_scatter_add_saturates_without_touching_neighbours(dev, shift):
    per, bits = 1 << shift, 32 >> shift
    cmax = (1 << bits) - 1
    lane_type = {0: "<u4", 1: "<u2", 2: "<u1"}[shift]

    def packed(lanes):
        return torch.from_numpy(lanes.astype(lane_type).view("<i4")
                                .astype(np.int32)).to(dev)

    lanes = np.arange(1, 4 * per + 1, dtype=np.uint64)
    lanes[1] = cmax - 3
    words = packed(lanes)
    # 10000 unit adds and 10000 adds of cmax onto counter 1
    pos = torch.full((20000,), 1, dtype=torch.int32, device=dev)
    inc = u64.to_u32_bits(torch.cat([
        torch.ones(10000, dtype=torch.int64),
        torch.full((10000,), cmax, dtype=torch.int64)])).to(dev)
    scatter_add.scatter_add(words, pos, shift, cmax, inc)
    lanes[1] = cmax
    assert torch.equal(words, packed(lanes))


# ---------------------------------------------------------------------------
# the wide (int64-position) instantiations of the counting kernels: a
# filter of exactly 2**32 counters; each held against its narrow twin on
# the same positions and against the plain version
# ---------------------------------------------------------------------------

def widen(pos: torch.Tensor) -> torch.Tensor:
    """Narrow positions (int32, 0xFFFFFFFF) in the wide form (int64, -1)."""
    return u64.positions64(pos)


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("h", [1, 4, 9])
def test_gather_counters_wide_matches_narrow_and_plain(dev, shift, h):
    rng = np.random.default_rng(100 + h + shift)
    nwords = 4099
    words = random_words(nwords, h).to(dev)
    pos = rng.integers(0, (nwords << shift) + 50, size=(h, 3, 3001),
                       dtype=np.uint64)
    pos[:, rng.random((3, 3001)) < 0.1] = 0xFFFFFFFF
    pos[rng.random((h, 3, 3001)) < 0.02] = 0xFFFFFFFF
    narrow = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    wide = widen(narrow)
    for out, thr in (("vals", 0), ("min", 0), ("hit", 60), ("hit", 200)):
        before = gather_counters.WIDE_KERNEL.launches
        got = gather_counters.gather_counters(words, wide, shift, out, thr)
        assert gather_counters.WIDE_KERNEL.launches == before + 1
        assert torch.equal(got, gather_counters.gather_counters(
            words, narrow, shift, out, thr))
        assert torch.equal(got, gather_counters.gather_counters_plain(
            words, wide, shift, out, thr))


@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("h", [4, 11])
def test_conservative_step_wide_matches_narrow_and_plain(dev, shift, h):
    rng = np.random.default_rng(200 + h + shift)
    cmax = (1 << (32 >> shift)) - 1
    nwords = 1 << 16
    ncount = nwords << shift
    pos, live = disjoint_frames(rng, ncount, h, 20_000)
    words = random_words(nwords, h + shift).to(dev)
    c = torch.from_numpy(rng.choice(np.array([1, 2, 300, 1 << 20], np.int64),
                                    size=pos.shape[1])).to(dev)
    narrow = torch.from_numpy(pos.view(np.int32)).to(dev)
    wide = widen(narrow)
    before = conservative_step.WIDE_KERNEL.launches
    got = conservative_step.conservative_step(words.clone(), wide, c, shift,
                                              cmax)
    assert conservative_step.WIDE_KERNEL.launches == before + 1
    assert torch.equal(got, conservative_step.conservative_step(
        words.clone(), narrow, c, shift, cmax))
    assert torch.equal(got, conservative_step.conservative_step_plain(
        words.clone(), wide, c, shift, cmax))
    assert not torch.equal(got, words)


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_scatter_add_wide_matches_narrow_and_plain(dev, shift):
    rng = np.random.default_rng(300 + shift)
    cmax = (1 << (32 >> shift)) - 1
    nwords = (1 << 18) + 5
    start = random_words(nwords, shift).to(dev)
    n = 60_000
    pos = rng.integers(0, (nwords << shift) + 64, size=n, dtype=np.uint64)
    pos[:2000] = pos[0]
    pos[rng.random(n) < 0.05] = 0xFFFFFFFF
    narrow = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    wide = widen(narrow)
    inc = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    inc[rng.random(n) < 0.3] = 1
    inc = torch.from_numpy(inc.astype(np.uint32).view(np.int32)).to(dev)
    for c in (None, inc):
        before = scatter_add.WIDE_KERNEL.launches
        got = scatter_add.scatter_add(start.clone(), wide, shift, cmax, c)
        assert scatter_add.WIDE_KERNEL.launches == before + 1
        assert torch.equal(got, scatter_add.scatter_add(
            start.clone(), narrow, shift, cmax, c))
        assert torch.equal(got, scatter_add.scatter_add_plain(
            start.clone(), wide, shift, cmax, c))
    with pytest.raises(TypeError):
        scatter_add.scatter_add_tiled(start.clone(), wide, shift, cmax)


def dense_and_sparse(nwords, word_shift, seed, n, hot=300_000):
    """int64 positions into an array of nwords words: n uniform ones (a few
    hundred a coarse tile), hot of them in one coarse tile near the end
    (many chunks of the sparse apply), a run of one repeated position,
    sentinels, positions past the array and the last position of the
    array."""
    rng = np.random.default_rng(seed)
    limit = nwords << word_shift
    pos = rng.integers(0, limit + 4000, size=n, dtype=np.int64)
    span = (tile_partition.TILE_SHIFT
            + tile_partition.coarse_shift(nwords) + word_shift)
    first = ((limit - 1) >> span << span) - (1 << span)
    pos[:hot] = rng.integers(first, first + (1 << span), size=hot)
    drop = rng.random(n) < 0.03
    drop[hot:hot + 50_000] = False
    pos[drop] = -1
    pos[hot:hot + 50_000] = rng.integers(0, limit)    # pos[hot]
    pos[-1000:] = limit - 1
    return torch.from_numpy(pos)


def test_scatter_add_sparse_at_2_32_counters(dev):
    """incrementAll into exactly 2**32 u8 counters (counter 0xFFFFFFFF
    live) by the rule's route, the sparse one: sparse coarse tiles and a
    dense one in one call, a counter saturated by 50,000 duplicates, counters
    already at counter_max, sentinels; equal to the plain version."""
    nwords = 1 << 30
    pos = dense_and_sparse(nwords, 2, 23, 4 * 3072 * 2018).to(dev)
    start = torch.randint(-(1 << 31), 1 << 31, (nwords,), dtype=torch.int32,
                          device=dev) & 0x3F3F3F3F
    start[-1] = -1                  # the last four counters at 255
    start[:1 << 20] |= 0x00FF0000   # lane 2 at 255 in the first 2**20 words
    assert scatter_add.route(nwords, pos.numel(), wide=True) == "sparse"
    kernels.reset_launch_counts()
    got = scatter_add.scatter_add(start.clone(), pos, 2, 255)
    counts = kernels.launch_counts()
    assert counts["scatter_add_sparse_wide"] == 1
    assert counts["tile_partition_wide"] == 1
    assert counts["scatter_add_wide"] == 0
    ref = scatter_add.scatter_add_plain(start.clone(), pos, 2, 255)
    assert torch.equal(got, ref)
    hot = int(pos[300_000])
    assert (int(got[hot >> 2]) >> ((hot & 3) * 8)) & 0xFF == 255
    # the last word from zero: counter 2**32 - 1 takes its 1000 adds
    start[-1] = 0
    got = scatter_add.scatter_add_sparse(start.clone(), pos, 2, 255)
    ref = scatter_add.scatter_add_plain(start.clone(), pos, 2, 255)
    assert torch.equal(got, ref) and int(got[-1]) != 0
    # the sparse route takes wide positions only
    with pytest.raises(TypeError):
        scatter_add.scatter_add_sparse(start[:1000].clone(), torch.zeros(
            10, dtype=torch.int32, device=dev), 2, 255)


def test_counting_at_exactly_2_32_counters_counts_the_last(dev):
    """A 2**32-counter u8 filter (4 GiB) on the card: frames on counters
    2**32 - 1 and 2**32 - 2, conservative update and incrementAll through
    the wide kernels, against a numpy stream-order oracle."""
    size = 1 << 32
    last, prev = size - 1, size - 2
    hashes = np.array([[last, prev, 7], [last, 9, 7], [last, last, 11],
                       [prev, 12, 13], [size + last, 5, 6]], np.uint64)
    cbf = counting.create(size, 3, 5, 1, device=dev)
    for name in ("conservative_step", "gather_counters", "scatter_add"):
        getattr(globals()[name], "WIDE_KERNEL").launches = 0
    counting.insert(cbf, u64.from_numpy(hashes))
    pos = (hashes % np.uint64(size)).astype(np.int64)
    uniq = np.unique(pos)
    ref = dict.fromkeys(uniq.tolist(), 0)
    for row in pos:                          # incrementMin, stream order
        m = min(ref[p] for p in row)
        for p in set(row.tolist()):
            if ref[p] == m:
                ref[p] += 1
    mc = counting.min_count(cbf, u64.from_numpy(hashes))
    assert mc.tolist() == [min(ref[p] for p in row) for row in pos]
    counting.insert_all(cbf, u64.from_numpy(hashes))
    for row in pos:                          # incrementAll
        for p in row.tolist():
            ref[p] += 1
    w = cbf.counters[torch.from_numpy(uniq >> 2).to(dev)].cpu().numpy()
    got = (w.view(np.uint32) >> ((uniq & 3) * 8).astype(np.uint32)) & 0xFF
    assert got.tolist() == [ref[p] for p in uniq.tolist()]
    assert ref[last] > 0
    assert conservative_step.WIDE_KERNEL.launches > 0
    assert gather_counters.WIDE_KERNEL.launches > 0
    assert scatter_add.WIDE_KERNEL.launches > 0


# ---------------------------------------------------------------------------
# the blocked Bloom filter's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nblocks", [1, 3, 1 << 10, (1 << 16) + 7])
@pytest.mark.parametrize("h", [1, 4, 7, 16, 17])
def test_blocked_kernels_match_plain(dev, nblocks, h):
    """Random canonical hashes, a valid mask, duplicates, both kernels
    against their plain versions; every inserted valid k-mer hits."""
    rng = np.random.default_rng(nblocks * 31 + h)
    n = 20_000
    canon = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    canon[: n // 10] = canon[n // 10: n // 5]           # duplicates
    c = u64.from_numpy(canon).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    rows = torch.zeros((nblocks, 16), dtype=torch.int32, device=dev)
    ref = rows.clone()
    before = (blocked_bloom.INSERT_KERNEL.launches,
              blocked_bloom.CONTAINS_KERNEL.launches)
    blocked_bloom.insert(rows, c[: n // 2], 21, h, valid[: n // 2])
    blocked_bloom.insert_plain(ref, c[: n // 2], 21, h, valid[: n // 2])
    assert torch.equal(rows, ref)
    for v in (None, valid):
        hit = blocked_bloom.contains(rows, c, 21, h, v)
        assert torch.equal(hit, blocked_bloom.contains_plain(rows, c, 21, h,
                                                             v))
    assert hit[: n // 2][valid[: n // 2]].all()
    assert (blocked_bloom.INSERT_KERNEL.launches,
            blocked_bloom.CONTAINS_KERNEL.launches) == (before[0] + 1,
                                                        before[1] + 2)


def test_blocked_filter_on_cuda_matches_cpu(dev):
    """The sequence entry points on the card and on the CPU: rows, hits,
    the .bbf bytes."""
    codes = random_codes(7, 500, 0.02, 5)
    gpu = blocked.insert_seq(blocked.create((1 << 20) + 512, 4, 31,
                                            device=dev), codes)
    cpu = blocked.insert_seq(blocked.create((1 << 20) + 512, 4, 31,
                                            device="cpu"), codes)
    assert torch.equal(gpu.rows.cpu(), cpu.rows)
    for a, b in zip(blocked.contains_seq(gpu, codes),
                    blocked.contains_seq(cpu, codes)):
        assert torch.equal(a.cpu(), b)


def test_blocked_bit_2_32_minus_1(dev):
    """At exactly 2**32 bits the last row's last bit is set and found."""
    bf = blocked.create(1 << 32, 4, 31, device=dev)
    rng = np.random.default_rng(7)
    while True:
        c = np.array([int(rng.integers(0, 1 << 41)) << 23
                      | ((1 << 23) - 1)], np.uint64)
        block, bits = blocked_bloom.block_and_bits(u64.from_numpy(c),
                                                   1 << 23, 31, 4)
        if 511 in bits[0].tolist():
            break
    blocked.insert(bf, u64.from_numpy(c))
    assert int(bf.rows[-1, 15]) < 0                      # bit 31 set
    assert bool(blocked.contains(bf, u64.from_numpy(c))[0])
    assert int((bf.rows != 0).sum()) <= 4


def test_blocked_insert_seq_bit_2_32_minus_1(dev):
    """The fused insert sets the last bit of a 2**32-bit filter: a 31-mer
    whose canonical hash has its low 23 bits set (the last block) and, at
    h = 4, bit 511 of the block."""
    codes = torch.tensor([["ACGT".index(b)
                           for b in "ACAAGCTGCGTTCCTCCCCTCCTCAACACCT"]],
                         dtype=torch.uint8)
    bf = blocked.insert_seq(blocked.create(1 << 32, 4, 31, device=dev),
                            codes)
    assert int(bf.rows[-1, 15]) < 0                      # bit 31 set
    assert int((bf.rows != 0).sum()) <= 4
    hit, valid = blocked.contains_seq(bf, codes)
    assert bool(hit.all()) and bool(valid.all())


def blocked_codes(kind, B, L, k, seed):
    """Reads of one kind: random with Ns, poly-A, a tandem repeat, reads
    shorter than k padded with N, all N, or a mix of them all."""
    codes = random_codes(B, L, 0.02, seed).numpy()
    if kind == "polyA":
        codes[:] = 0
    elif kind == "tandem":
        codes[:] = np.tile(np.array([0, 1, 1, 3, 2], np.uint8), L)[:L]
    elif kind == "short":
        for b in range(0, B, 2):
            codes[b, k - 1 - b % 3:] = 4
    elif kind == "allN":
        codes[:] = 4
    elif kind == "mixed":
        codes[0] = 0
        codes[1] = 3
        codes[2, k // 2:] = 4
        codes[3] = 4
    return torch.from_numpy(codes)


BLOCKED_SEQ = [  # kind, B, L, k, h, nblocks
    ("random", 6, 701, 31, 4, 1 << 12),
    ("random", 6, 700, 31, 1, (1 << 12) + 7),
    ("random", 5, 2100, 31, 17, 3),        # past one tile; h past 16 words
    ("random", 4, 901, 129, 4, 1000),
    ("mixed", 7, 513, 31, 4, 777),
    ("mixed", 5, 2061, 129, 17, 1 << 10),
    ("polyA", 8, 300, 31, 4, 777),
    ("polyA", 4, 900, 129, 17, 1 << 10),
    ("tandem", 6, 402, 31, 4, 1 << 10),
    ("short", 5, 200, 31, 4, 1 << 10),
    ("allN", 3, 200, 31, 4, 1 << 10),
    ("random", 1, 31, 31, 4, 5),           # one window
]


@pytest.mark.parametrize("kind,B,L,k,h,nblocks", BLOCKED_SEQ)
def test_blocked_insert_seq_matches_plain(dev, kind, B, L, k, h, nblocks):
    """The fused insert against ntHash's plain hash mode and the plain
    insert, into empty rows and again (the bits already set), one launch
    a call and no separate ntHash launch."""
    codes = blocked_codes(kind, B, L, k, B * L + k + h)
    rows = torch.zeros((nblocks, 16), dtype=torch.int32, device=dev)
    ref = torch.zeros((nblocks, 16), dtype=torch.int32)
    before = (blocked_bloom.SEQ_KERNEL.launches, nthash_scan.KERNEL.launches)
    for _ in range(2):
        blocked_bloom.insert_seq(rows, codes.to(dev), k, h)
        blocked_bloom.insert_seq_plain(ref, codes, k, h)
        assert torch.equal(rows.cpu(), ref)
    assert (blocked_bloom.SEQ_KERNEL.launches,
            nthash_scan.KERNEL.launches) == (before[0] + 2, before[1])


@pytest.mark.parametrize("kind", ["polyA", "twice", "runs"])
def test_blocked_insert_repeats(dev, kind):
    """The canonical-hash insert on repeated k-mers: one hash a million
    times, a batch inserted twice, runs of equal hashes across warps."""
    rng = np.random.default_rng(3)
    n = 1 << 20 if kind == "polyA" else 50_000
    canon = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    if kind == "polyA":
        canon[:] = canon[0]
    elif kind == "runs":
        canon = np.repeat(canon[: n // 37 + 1], 37)[:n]
    c = u64.from_numpy(canon)
    valid = torch.from_numpy(rng.random(n) < 0.95)
    rows = torch.zeros((1 << 12) + 3, 16, dtype=torch.int32, device=dev)
    ref = torch.zeros((1 << 12) + 3, 16, dtype=torch.int32)
    for _ in range(2 if kind == "twice" else 1):
        blocked_bloom.insert(rows, c.to(dev), 31, 4, valid.to(dev))
        blocked_bloom.insert_plain(ref, c, 31, 4, valid)
        assert torch.equal(rows.cpu(), ref)


def test_blocked_insert_seq_path_launches(dev):
    """blocked.insert_seq on the card launches the fused kernel alone."""
    codes = random_codes(4, 600, 0.02, 9)
    before = kernels.launch_counts()
    bf = blocked.insert_seq(blocked.create(1 << 20, 4, 31, device=dev), codes)
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"blocked_insert_seq": 1}
    ref = blocked.insert_seq(blocked.create(1 << 20, 4, 31, device="cpu"),
                             codes)
    assert torch.equal(bf.rows.cpu(), ref.rows)


# ---------------------------------------------------------------------------
# the tile partition and the tiled routes of the two scatters
# ---------------------------------------------------------------------------

def edge_positions(kind, nwords, word_shift, rng, n=60_000):
    """uint64 positions of one edge case for an array of nwords words."""
    sent = 0xFFFFFFFF
    limit = min((nwords << word_shift) + 5000, 1 << 32)
    if kind == "empty":
        return np.zeros(0, np.uint64)
    if kind == "all_sentinels":
        return np.full(1000, sent, np.uint64)
    if kind == "below_stage":     # fewer than one chunk of the partition
        n = 3001
    if kind == "one_tile":        # every live position in one tile
        t = (nwords - 1) >> tile_partition.TILE_SHIFT >> 1
        lo = (t << tile_partition.TILE_SHIFT) << word_shift
        hi = min(((t + 1) << tile_partition.TILE_SHIFT) << word_shift,
                 nwords << word_shift)
        pos = rng.integers(lo, hi, size=200_000, dtype=np.uint64)
        pos[rng.random(pos.size) < 0.05] = sent
        return pos
    pos = rng.integers(0, limit, size=n, dtype=np.uint64)
    pos[rng.random(n) < 0.05] = sent
    if kind == "hot":             # one counter or bit repeated many times
        pos[:5000] = pos[7]
    if kind == "last_tile":       # all in the ragged last tile
        first = ((nwords - 1) >> tile_partition.TILE_SHIFT) \
            << tile_partition.TILE_SHIFT
        pos = rng.integers(first << word_shift, nwords << word_shift,
                           size=n, dtype=np.uint64)
    return pos


def canonical(offsets, grouped):
    """(offsets, the live head sorted): the tile grouping with the free
    order inside a tile taken out."""
    total = int(offsets[-1])
    return offsets, torch.sort(grouped[:total].to(torch.int64)
                               & 0xFFFFFFFF).values


@pytest.mark.parametrize("kind", ["random", "empty", "all_sentinels", "hot",
                                  "last_tile", "below_stage", "one_tile",
                                  "unaligned"])
@pytest.mark.parametrize("nwords,word_shift", [
    (1, 5), (37, 2), ((1 << 20) + 3, 5), ((1 << 20) + 3, 2),
    ((1 << 27) - 2, 5), (1 << 15, 0), ((1 << 20) + 3, 0),
    (1 << 25, 5), (1 << 28, 2),
    (tile_partition.MAX_TILES << tile_partition.TILE_SHIFT, 0),
    ((tile_partition.MAX_TILES << tile_partition.TILE_SHIFT) - 7, 2)])
def test_tile_partition_kernel_matches_plain(dev, kind, nwords, word_shift):
    """One scatter pass (up to 2048 tiles: 1, 2, 65, 2048) and two (8192,
    16384, MAX_TILES tiles); "unaligned" takes a view one element into a
    tensor."""
    rng = np.random.default_rng(nwords + word_shift)
    pos = edge_positions(kind, nwords, word_shift, rng)
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    if kind == "unaligned":
        pos = torch.cat([pos[:1], pos])[1:]
        assert pos.data_ptr() % 16
    before = tile_partition.KERNEL.launches
    got = tile_partition.tile_partition(pos, nwords, word_shift)
    ref = tile_partition.tile_partition_plain(pos, nwords, word_shift)
    assert tile_partition.KERNEL.launches == before + 1
    g_off, g_key = canonical(*got)
    r_off, r_key = canonical(*ref)
    assert torch.equal(g_off, r_off) and torch.equal(g_key, r_key)
    # every position sits in its tile's run
    total = int(g_off[-1])
    tiles = torch.repeat_interleave(
        torch.arange(g_off.numel() - 1, device=dev),
        (g_off[1:] - g_off[:-1]).long())
    p = got[1][:total].to(torch.int64) & 0xFFFFFFFF
    assert torch.equal((p >> word_shift) >> tile_partition.TILE_SHIFT, tiles)


ROUTES = {"direct": (scatter_or.scatter_or_direct, scatter_or.KERNEL,
                     scatter_add.scatter_add_direct),
          "tiled": (scatter_or.scatter_or_tiled, scatter_or.TILED_KERNEL,
                    scatter_add.scatter_add_tiled)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["random", "empty", "all_sentinels", "hot",
                                  "last_tile"])
@pytest.mark.parametrize("nwords", [1, 37, (1 << 20) + 3, (1 << 27) - 2])
def test_scatter_or_routes_match_plain(dev, route, kind, nwords):
    rng = np.random.default_rng(nwords + 7)
    pos = edge_positions(kind, nwords, 5, rng)
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    start = (random_words(nwords, 3) & 0x01010101).to(dev)
    fn, kernel, _ = ROUTES[route]
    before = kernel.launches
    got = fn(start.clone(), pos)
    ref = scatter_or.scatter_or_plain(start.clone(), pos)
    assert torch.equal(got, ref)
    assert kernel.launches == before + int(pos.numel() > 0)


def test_tiled_scatters_on_unaligned_words(dev):
    """An array view 4 bytes past a 16-byte boundary: the add's sweep loads
    and stores its tiles 4 bytes at a time."""
    rng = np.random.default_rng(5)
    nwords = (1 << 16) + 9
    backing = torch.zeros(nwords + 1, dtype=torch.int32, device=dev)
    words = backing[1:]
    pos = torch.from_numpy(rng.integers(0, nwords * 32, size=50_000)
                           .astype(np.uint32).view(np.int32)).to(dev)
    scatter_or.scatter_or_tiled(words, pos)
    ref = scatter_or.scatter_or_plain(torch.zeros(nwords, dtype=torch.int32,
                                                  device=dev), pos)
    assert torch.equal(words, ref) and int(backing[0]) == 0
    backing.zero_()
    pos = torch.from_numpy(rng.integers(0, nwords, size=50_000)
                           .astype(np.uint32).view(np.int32)).to(dev)
    scatter_add.scatter_add_tiled(words, pos, 0, 0xFFFFFFFF)
    ref = scatter_add.scatter_add_plain(torch.zeros_like(ref), pos, 0,
                                        0xFFFFFFFF)
    assert torch.equal(words, ref) and int(backing[0]) == 0


def test_scatter_or_rule_takes_the_tiled_route_on_the_card(dev):
    nwords, npos = 1 << 25, 1 << 22
    assert scatter_or.route(nwords, npos) == "tiled"
    rng = np.random.default_rng(9)
    pos = torch.from_numpy(rng.integers(0, nwords * 32, size=npos)
                           .astype(np.uint32).view(np.int32)).to(dev)
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    scatter_or.scatter_or(words, pos)
    counts = kernels.launch_counts()
    assert counts["scatter_or_tiled"] == counts["tile_partition"] == 1
    assert counts["scatter_or"] == 0
    assert torch.equal(words, scatter_or.scatter_or_plain(
        torch.zeros_like(words), pos))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("nwords", [1, 37, (1 << 18) + 5])
@pytest.mark.parametrize("kind", ["random", "hot", "last_tile"])
def test_scatter_add_routes_match_plain(dev, route, shift, nwords, kind):
    """Unit adds by each route, a hot counter driven past counter_max;
    weighted ones (full uint32 increments with zeros among them) by the
    direct route, the only one that takes them."""
    rng = np.random.default_rng(nwords * 3 + shift)
    cmax = (1 << (32 >> shift)) - 1
    start = random_words(nwords, nwords).to(dev)
    pos = edge_positions(kind, nwords, shift, rng)
    n = pos.size
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32)).to(dev)
    inc = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    inc[rng.random(n) < 0.3] = rng.integers(0, 4, size=1)[0]
    inc = torch.from_numpy(inc.astype(np.uint32).view(np.int32)).to(dev)
    for c in (None, inc) if route == "direct" else (None,):
        got = ROUTES[route][2](start.clone(), pos, shift, cmax,
                               *(() if c is None else (c,)))
        ref = scatter_add.scatter_add_plain(start.clone(), pos, shift, cmax,
                                            c)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_scatter_add_tiled_saturates_without_touching_neighbours(dev, shift):
    per, bits = 1 << shift, 32 >> shift
    cmax = (1 << bits) - 1
    nwords = (1 << 16) + 3
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    # 20000 unit adds onto counter 1, 300 onto the last counter
    last = (nwords << shift) - 1
    pos = torch.tensor([1] * 20000 + [last] * 300, dtype=torch.int32,
                       device=dev)
    scatter_add.scatter_add_tiled(words, pos, shift, cmax)
    ref = scatter_add.scatter_add_plain(torch.zeros_like(words), pos, shift,
                                        cmax)
    assert torch.equal(words, ref)
    lanes = words.cpu().numpy().view({0: "<u4", 1: "<u2", 2: "<u1"}[shift])
    assert lanes[1] == min(20000, cmax) and lanes[last] == min(300, cmax)
    assert np.count_nonzero(lanes) == 2


def test_scatter_add_rule_takes_the_tiled_route_on_the_card(dev):
    nwords, npos = 1 << 26, 1 << 22
    assert scatter_add.route(nwords, npos) == "tiled"
    rng = np.random.default_rng(10)
    pos = torch.from_numpy(rng.integers(0, nwords * 4, size=npos)
                           .astype(np.uint32).view(np.int32)).to(dev)
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    kernels.reset_launch_counts()
    scatter_add.scatter_add(words, pos, 2, 255)
    counts = kernels.launch_counts()
    assert counts["scatter_add_tiled"] == counts["tile_partition"] == 1
    assert counts["scatter_add"] == 0
    assert torch.equal(words, scatter_add.scatter_add_plain(
        torch.zeros_like(words), pos, 2, 255))
    # weighted adds at the same shape take the direct route
    assert scatter_add.route(nwords, npos, weighted=True) == "direct"
    inc = torch.from_numpy(rng.integers(0, 3, size=npos).astype(np.int32)
                           ).to(dev)
    kernels.reset_launch_counts()
    got = scatter_add.scatter_add(words.clone(), pos, 2, 255, inc)
    counts = kernels.launch_counts()
    assert counts["scatter_add"] == 1
    assert counts["scatter_add_tiled"] == counts["tile_partition"] == 0
    assert torch.equal(got, scatter_add.scatter_add_plain(
        words.clone(), pos, 2, 255, inc))


def cbf_stream(n, h, size_bytes, repeat, width, seed):
    rng = np.random.default_rng(seed)
    hs = rng.integers(0, 1 << 64, size=(n, h), dtype=np.uint64)
    if repeat > 1:
        ridx = np.tile(np.arange(n), repeat)
        rng.shuffle(ridx)
        hs = hs[ridx]
    valid = rng.random(hs.shape[0]) < 0.9
    return u64.from_numpy(hs), torch.from_numpy(valid)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("size_bytes,repeat,max_entangled", [
    (1 << 16, 1, None), (256, 1, None), (2048, 6, None), (128, 1, 16)])
def test_counting_on_cuda_matches_cpu(dev, width, group, size_bytes, repeat,
                                      max_entangled):
    """Conservative update (sparse, dense, coverage-like, and past the
    replay buffer), incrementAll with duplicates, min count and membership:
    the card's kernels against the CPU's plain path."""
    hs, valid = cbf_stream(400, 3, size_bytes, repeat, width, size_bytes)
    gpu = counting.create(size_bytes, 3, 5, 2, counter_width=width,
                          device=dev)
    cpu = counting.create(size_bytes, 3, 5, 2, counter_width=width,
                          device="cpu")
    kernels.reset_launch_counts()
    for cbf in (gpu, cpu):
        counting.insert(cbf, hs, valid, max_entangled=max_entangled,
                        group_duplicates=group)
        counting.insert_all(cbf, hs[:50])
    assert torch.equal(gpu.counters.cpu(), cpu.counters)
    assert torch.equal(counting.min_count(gpu, hs).cpu(),
                       counting.min_count(cpu, hs))
    assert torch.equal(counting.contains(gpu, hs).cpu(),
                       counting.contains(cpu, hs))
    counts = kernels.launch_counts()
    if width == 8:
        assert counts["gather_counters"] == counts["scatter_add"] == 0
        assert counts["conservative_step"] == 0
    else:
        # the insert: the closed form and at least one replay round
        assert counts["conservative_step"] >= 2
        assert counts["gather_counters"] >= 2 and counts["scatter_add"] >= 1


def test_counting_seq_on_cuda_matches_cpu(dev):
    codes = random_codes(16, 700, 0.02, 7)
    gpu = counting.create(1 << 20, 4, 25, 1, device=dev)
    cpu = counting.create(1 << 20, 4, 25, 1, device="cpu")
    for cbf in (gpu, cpu):
        counting.insert_seq(cbf, codes, group_duplicates=False)
        counting.insert_seq(cbf, codes[:8])
    assert torch.equal(gpu.counters.cpu(), cpu.counters)
    probe = torch.cat([codes[:8], random_codes(8, 700, 0.02, 8)])
    for a, b in zip(counting.min_count_seq(gpu, probe),
                    counting.min_count_seq(cpu, probe)):
        assert torch.equal(a.cpu(), b)
    hit, valid = counting.contains_seq(gpu, probe)
    assert torch.equal(hit.cpu(), counting.contains_seq(cpu, probe)[0])
    assert torch.equal(hit[:8], valid[:8])


# ---------------------------------------------------------------------------
# MIBF kernels
# ---------------------------------------------------------------------------

def mibf_vector(nwords, seed, density=0.5):
    """Random bit-vector words (int32 uint32 bits) and their exclusive
    cumulative popcounts."""
    from btl_bloomfilter_tpu_torch.models import mibf
    rng = np.random.default_rng(seed)
    bits = rng.random(nwords * 32) < density
    words = np.packbits(bits, bitorder="little").view(np.uint32)
    m = mibf.freeze(torch.from_numpy(words.view(np.int32)), nwords * 32, 4,
                    21)
    return m.bv_words, m.cum_ranks, m.rank_dir, m.d_size


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("nwords", [1, 6, 7, 8, 13, 37, 1 << 16])
def test_mibf_rank_kernel_matches_plain(dev, width, nwords):
    """Sizes around the rank directory's 7-word block (65536 words is not
    a multiple of it), positions past the vector among them."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    from btl_bloomfilter_tpu_torch.models import mibf
    bv, cum, rdir, d_size = mibf_vector(nwords, nwords + width)
    rng = np.random.default_rng(width)
    n = 40_000
    pos = rng.integers(0, nwords * 32, size=n, dtype=np.uint64)
    last = nwords * 32 - 1
    pos[:64] = np.arange(64) % 32 + (last - 31)   # the last word, bits 0-31
    pos[64:96] = 0                                 # bit 0 of word 0
    pos[96:128] = last                             # bit 31 of the last word
    pos[128:1128] = rng.integers(last + 1, 1 << 32, size=1000)  # past it
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32))
    lo = 0 if width == 1 else -(1 << (8 * width - 1))
    data = torch.from_numpy(rng.integers(lo, lo + (1 << (8 * width)),
                                         size=d_size)).to(mibf.STORAGE[width])
    args = (bv.to(dev), cum.to(dev), rdir.to(dev), pos.to(dev))
    before = mibf_rank.KERNEL.launches
    got = mibf_rank.rank_lookup(*args, data.to(dev))
    ref = mibf_rank.rank_lookup_plain(bv, cum, rdir, pos, data)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    rank_only = mibf_rank.rank_lookup(*args)
    assert rank_only[2] is None
    assert torch.equal(rank_only[0].cpu(), ref[0])
    assert torch.equal(rank_only[1].cpu(), ref[1])
    assert mibf_rank.KERNEL.launches == before + 2


def test_mibf_rank_refuses_ranks_past_int32(dev):
    """An ID plane of 2**31 entries would need ranks past int32: refused
    before any launch (a broadcast view, so nothing is allocated)."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    bv, cum, rdir, _ = mibf_vector(13, 5)
    data = torch.zeros(1, dtype=torch.uint8, device=dev).expand(1 << 31)
    pos = torch.zeros(10, dtype=torch.int32, device=dev)
    before = mibf_rank.KERNEL.launches
    with pytest.raises(ValueError, match="2\\*\\*31"):
        mibf_rank.rank_lookup(bv.to(dev), cum.to(dev), rdir.to(dev), pos,
                              data)
    assert mibf_rank.KERNEL.launches == before


def test_mibf_rank_clamps_rank_d_size(dev):
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    words = torch.tensor([0b1011, 0], dtype=torch.int32)   # bits 0, 1, 3
    cum = torch.tensor([0, 3], dtype=torch.int32)
    rdir = mibf_rank.rank_directory(words, cum)
    data = torch.tensor([5, 6, 7], dtype=torch.int16)
    pos = torch.tensor([0, 1, 2, 3, 4, 63], dtype=torch.int32)
    got = mibf_rank.rank_lookup(words.to(dev), cum.to(dev), rdir.to(dev),
                                pos.to(dev), data.to(dev))
    assert got[0].tolist() == [0, 1, 2, 2, 3, 3]
    assert got[1].tolist() == [True, True, False, True, False, False]
    assert got[2].tolist() == [5, 6, 0, 7, 0, 0]


@pytest.mark.parametrize("nwords", [1, 6, 7, 8, 13, 37, 1 << 16])
def test_mibf_rank_u64_kernel_matches_plain(dev, nwords):
    """The width-8 form (the uint64 ID plane, raw int64) at the same sizes
    and positions, IDs of every bit pattern; it counts as U64_KERNEL and
    leaves the narrow form's count alone."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    bv, cum, rdir, d_size = mibf_vector(nwords, nwords + 8)
    rng = np.random.default_rng(nwords)
    pos = rng.integers(0, nwords * 32, size=40_000, dtype=np.uint64)
    pos[:32] = nwords * 32 - 1 - np.arange(32)
    pos[32:1032] = rng.integers(nwords * 32, 1 << 32, size=1000)
    pos = torch.from_numpy(pos.astype(np.uint32).view(np.int32))
    data = torch.from_numpy(rng.integers(0, 1 << 64, size=d_size,
                                         dtype=np.uint64).view(np.int64))
    args = (bv.to(dev), cum.to(dev), rdir.to(dev), pos.to(dev))
    narrow, wide = mibf_rank.KERNEL.launches, mibf_rank.U64_KERNEL.launches
    got = mibf_rank.rank_lookup(*args, data.to(dev))
    ref = mibf_rank.rank_lookup_plain(bv, cum, rdir, pos, data)
    assert ref[2].dtype == torch.int64
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    assert (mibf_rank.KERNEL.launches, mibf_rank.U64_KERNEL.launches) == (
        narrow, wide + 1)


def test_mibf_rank_u64_clamps_rank_d_size(dev):
    from btl_bloomfilter_tpu_torch.kernels import mibf_rank
    words = torch.tensor([0b1011, 0], dtype=torch.int32)   # bits 0, 1, 3
    cum = torch.tensor([0, 3], dtype=torch.int32)
    rdir = mibf_rank.rank_directory(words, cum)
    ids = [(37 << 40) | 5, -(1 << 63) | 6, -1]
    data = torch.tensor(ids, dtype=torch.int64)
    pos = torch.tensor([0, 1, 2, 3, 4, 63], dtype=torch.int32)
    got = mibf_rank.rank_lookup(words.to(dev), cum.to(dev), rdir.to(dev),
                                pos.to(dev), data.to(dev))
    assert got[0].tolist() == [0, 1, 2, 2, 3, 3]
    assert got[2].tolist() == [ids[0], ids[1], 0, ids[2], 0, 0]


def test_mibf_width8_on_cuda_matches_cpu(dev):
    """The width-8 MIBF build (phases 1-4), lookups, saturate, set_data and
    statistics on the card equal the same calls on the CPU."""
    from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct
    big = (37 << 40) | 12345
    rng = np.random.default_rng(3)
    hashes = torch.from_numpy(rng.integers(0, 1 << 64, size=(4, 300, 4),
                                           dtype=np.uint64).view(np.int64))
    hashes[1, :50] = hashes[0, :50]
    valid = torch.from_numpy(rng.random((4, 300)) < 0.9)
    ids = [big, 3, big + 1, 9]
    out = []
    for d in ("cpu", dev):
        st = mibf_construct.create(1200, 21, 4, 0.5, device=d)
        for g in range(4):
            mibf_construct.insert_bv(st, hashes[g], valid[g])
        m, counts = mibf_construct.get_empty_mibf(st, 8)
        mibf_construct.insert_mibf_many(m, counts, hashes, ids, valid)
        mibf_construct.insert_saturation_many(m, counts, hashes, ids, valid)
        mibf.saturate(m, hashes[2, :10])
        rank, _ = mibf.at_rank(m, hashes[3, :5])
        mibf.set_data(m, rank, torch.full(rank.shape, big + 2).reshape(-1))
        at = mibf.at(m, hashes[:, :100], 1)
        out.append([st.bv_words, m.data, counts, *at,
                    *mibf.at_rank_data(m, hashes),
                    mibf.get_id_counts(m, 16)[0],
                    mibf.get_pop_saturated(m), mibf.get_pop_non_zero(m)])
    for a, b in zip(*out):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b.cpu())
        else:
            assert a == b


def frame_scan_inputs(R, W, h, seed, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    c6 = torch.from_numpy(rng.integers(0, 30, size=(R, W, h, 6))
                          .astype(np.int32)).cumsum(1).to(torch.int32)
    return (c6, torch.from_numpy(rng.random((R, W, h)) < 0.6),
            torch.from_numpy(rng.integers(1, 40, size=(R, W, h))
                             .astype(np.int32)),
            torch.from_numpy(rng.random((R, W)) < valid_frac),
            torch.from_numpy(rng.random((R, W)) < 0.2),
            torch.from_numpy(rng.random((R, W)) < 0.9),
            torch.from_numpy(rng.integers(0, h + 1, size=(R, W))
                             .astype(np.int32)))


def check_frame_scan(dev, inputs, efl):
    """The kernel against the plain version on inputs (CPU tensors), one
    launch; returns the plain outputs."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_frame_scan
    before = mibf_frame_scan.KERNEL.launches
    got = mibf_frame_scan.frame_scan(*(t.to(dev) for t in inputs), efl)
    ref = mibf_frame_scan.frame_scan_plain(*inputs, efl)
    assert mibf_frame_scan.KERNEL.launches == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    return ref


@pytest.mark.parametrize("R,W,h,efl,valid_frac", [
    (1, 1, 1, 10**6, 1.0),
    (70, 300, 4, 10**6, 0.9),
    (33, 200, 3, 0, 0.9),        # the early exit at its tightest
    (40, 100, 4, 2, 1.0),
    (5, 50, 2, 10**6, 0.0),      # reads of all-invalid frames
    # three chunks of 256 frames, the last one ragged
    (20, 700, 4, -1, 0.9),
    (20, 700, 4, 0, 0.9),
    (20, 700, 4, 1, 0.7),
    (12, 1000, 5, 10**6, 0.9),
    (8, 300, 9, 10**6, 0.9),     # many slots a frame
    (6, 520, 11, 0, 0.9),
    (256, 2018, 4, 10**6, 0.9),  # the bench batch
])
def test_mibf_frame_scan_kernel_matches_plain(dev, R, W, h, efl, valid_frac):
    inputs = frame_scan_inputs(R, W, h, R * W + h, valid_frac)
    ref = check_frame_scan(dev, inputs, efl)
    if efl <= 0 and valid_frac:
        assert not ref[1].all()          # some read stopped early


@pytest.mark.parametrize("efl", [-1, 0, 1, 10**6])
def test_mibf_frame_scan_read_that_never_promotes(dev, efl):
    """One read among many has no slot at or above its min count: it
    promotes nothing, and its best stays 0."""
    inputs = list(frame_scan_inputs(9, 600, 4, 17, 0.9))
    inputs[2] = inputs[2].clone()
    inputs[2][4] = torch.iinfo(torch.int32).max
    ref = check_frame_scan(dev, inputs, efl)
    assert not ref[0][4].any() and ref[2][4].tolist() == [0] * 6
    assert int(ref[0].any(dim=2).any(dim=1).sum()) == 8


def staged_inputs(R, W, h, first):
    """Reads that promote slot 0 first at frame ``first`` (its min count
    out of reach before) and at every frame after, leading with no second
    best: from ``first`` on the extra count rises by one a frame, so the
    extra-frame limit ``stop - first - 1`` stops the read at frame
    ``stop``."""
    c6 = torch.zeros((R, W, h, 6), dtype=torch.int32)
    c6[..., 0] = 5
    c6[..., 3] = 100              # totalNonSat far from the second best
    c6[..., 4] = 50 * torch.arange(1, W + 1, dtype=torch.int32)[:, None]
    consider = torch.zeros((R, W, h), dtype=torch.bool)
    consider[:, :, 0] = True
    mc = torch.ones((R, W, h), dtype=torch.int32)
    mc[:, :first] = torch.iinfo(torch.int32).max
    valid = torch.ones((R, W), dtype=torch.bool)
    hits = torch.full((R, W), h, dtype=torch.int32)
    return (c6, consider, mc, valid, torch.zeros_like(valid), valid, hits)


@pytest.mark.parametrize("W,first,stop", [
    (700, 0, 0),        # the first frame
    (700, 600, 650),    # a first promotion deep in the read
    (700, 100, 256),    # the first frame of a chunk
    (700, 100, 511),    # the last frame of a chunk
    (700, 300, 699),    # the read's last frame
    (513, 255, 256),    # promoted at a chunk's end, stopped just past it
])
def test_mibf_frame_scan_staged_promotion_and_stop(dev, W, first, stop):
    ref = check_frame_scan(dev, staged_inputs(3, W, 2, first),
                           stop - first - 1)
    assert ref[1].sum(dim=1).tolist() == [stop + 1] * 3
    assert ref[0][:, :, 0].sum(dim=1).tolist() == [stop - first + 1] * 3


def test_mibf_frame_scan_stops_at_frame_zero(dev):
    """One promoted slot whose nonSatFrame lead is past the limit at the
    first frame: the read stops there, and later frames are inactive."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_frame_scan
    R, W, h = 2, 6, 2
    c6 = torch.zeros((R, W, h, 6), dtype=torch.int32)
    c6[:, :, :, 0] = 5
    c6[:, :, :, 3] = 100          # totalNonSat far from the second best
    # nonSatFrame: leading, and rising, so the second best stays 0
    c6[:, :, :, 4] = 50 * torch.arange(1, W + 1, dtype=torch.int32)[:, None]
    consider = torch.zeros((R, W, h), dtype=torch.bool)
    consider[:, :, 0] = True
    mc = torch.ones((R, W, h), dtype=torch.int32)
    valid = torch.ones((R, W), dtype=torch.bool)
    zeros = torch.zeros((R, W), dtype=torch.bool)
    hits = torch.full((R, W), h, dtype=torch.int32)
    inputs = (c6, consider, mc, valid, zeros, valid, hits)
    for efl, active_frames in ((-1, 1), (0, 2)):
        got = mibf_frame_scan.frame_scan(*(t.to(dev) for t in inputs), efl)
        ref = mibf_frame_scan.frame_scan_plain(*inputs, efl)
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b)
        assert ref[1].sum(dim=1).tolist() == [active_frames] * R


def test_mibf_on_cuda_matches_cpu(dev):
    """The 4-phase build and a classification on the card against the
    CPU's plain path, with the launches of both MIBF kernels."""
    from btl_bloomfilter_tpu_torch import api
    from btl_bloomfilter_tpu_torch.models import (mibf, mibf_construct,
                                                  mibf_query)
    rng = np.random.default_rng(3)
    refs = [rng.integers(0, 4, size=int(n), dtype=np.uint8)
            for n in rng.integers(400, 900, size=7)]
    reads = [r[50:250] for r in refs]
    out = []
    kernels.reset_launch_counts()
    for device in (dev, torch.device("cpu")):
        pipe = api.MIBFConstructPipeline(mibf_construct.create(
            sum(map(len, refs)), 21, 3, device=device))
        for c in refs:
            pipe.insert_bv_seq(c)
        pipe.freeze(2)
        pipe.insert_mibf_batch(refs, range(1, 8))
        pipe.insert_saturation_batch(refs, range(1, 8))
        fr = pipe.hash.frames_batch(reads)
        qs = mibf_query.MIBFQuerySupport(
            m=pipe.m, per_frame_prob=[0.0] + [0.1] * 7, extra_count=2.0,
            extra_frame_limit=10**6, max_miss=0, min_count=1,
            best_hit_agree=False)
        res = qs.query_many(fr.hashes, fr.valid, np.full(8, 2, np.int32))
        out.append((mibf.to_numpy(pipe.m), pipe.counts.cpu(), res,
                    qs.eval_count))
    for a, b in zip(out[0][0], out[1][0]):
        assert np.array_equal(a, b)
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2:] == out[1][2:]
    assert [r[0].id for r in out[0][2]] == list(range(1, 8))
    counts = kernels.launch_counts()
    assert counts["mibf_rank"] == 3 and counts["mibf_frame_scan"] == 1


# ---------------------------------------------------------------------------
# the probe kernels and insert_and_check
# ---------------------------------------------------------------------------

TILE = 1 << tile_partition.TILE_SHIFT
# kinds at the edges of the delta form's tiles (64 KiB of the filter): a
# filter of 3 tiles and a partial tail
TILE_KINDS = ("tile_boundary", "run_across_warp_and_tile",
              "last_partial_tile", "unaligned_view", "unaligned_positions",
              "unsorted_all_tiles")


def sorted_positions(kind, nwords, rng):
    """int32 positions (uint32 bits) of one edge case."""
    sent = 0xFFFFFFFF
    if kind == "empty":
        pos = np.zeros(0, np.uint64)
    elif kind == "all_sentinels":
        pos = np.full(1000, sent, np.uint64)
    elif kind == "past_nwords":     # sorted, words past the filter, then
        pos = np.sort(rng.integers(0, nwords * 32 + 5000, size=20_000))
        pos = np.concatenate([pos, np.full(333, sent)])   # sentinels
    elif kind == "ragged":          # not a multiple of the 256-thread tile
        pos = np.sort(rng.integers(0, nwords * 32, size=256 * 40 + 77))
    elif kind == "one_position":
        pos = np.array([nwords * 16 + 5])
    elif kind == "partial_warp":    # fewer than a warp, a run at its end
        pos = np.sort(np.concatenate([rng.integers(0, nwords * 32, size=40),
                                      [nwords * 32 - 2, nwords * 32 - 1]]))
    elif kind == "runs_across_tiles":   # runs of 300 slots on one word
        n = 256 * 12 + 5
        pos = (np.arange(n) // 300) * 32 + rng.integers(0, 32, size=n)
        pos = np.sort(pos)
    elif kind == "in_place_sentinels":  # duplicates set to the sentinel
        pos = np.sort(rng.integers(0, 3000, size=30_000))
        dup = np.concatenate([[False], pos[1:] == pos[:-1]])
        pos = np.where(dup, sent, pos)
    elif kind == "tile_boundary":   # each side of every tile boundary
        edge = np.arange(1, nwords // TILE + 1) * TILE * 32
        pos = np.sort(np.concatenate([
            (edge[:, None] + np.arange(-70, 70)).ravel(),
            rng.integers(0, nwords * 32, size=3000)]))
    elif kind == "run_across_warp_and_tile":
        # 300 slots on the last word of tile 0, from slot 45 (not a warp's
        # first lane), then 300 on the first word of tile 1
        pos = np.sort(np.concatenate([
            rng.integers(0, (TILE - 1) * 32, size=45),
            (TILE - 1) * 32 + rng.integers(0, 32, size=300),
            TILE * 32 + rng.integers(0, 32, size=300),
            rng.integers((TILE + 1) * 32, nwords * 32, size=2000)]))
    elif kind == "last_partial_tile":   # the tail tile and past the filter
        lo = nwords // TILE * TILE * 32
        pos = np.sort(rng.integers(lo, nwords * 32 + 3000, size=5000))
        pos[-1] = nwords * 32 - 1
        pos = np.sort(pos)
    elif kind in ("unaligned_view", "unaligned_positions"):
        pos = np.sort(rng.integers(0, nwords * 32, size=20_003))
    elif kind == "unsorted_all_tiles":  # every tile, any order, sentinels
        pos = rng.integers(0, nwords * 32, size=30_000)
        pos[rng.random(30_000) < 0.1] = sent
        pos[:4] = [nwords * 32 - 1, 0, TILE * 32, 2 * TILE * 32 - 1]
    else:                           # unsorted, duplicates, sentinels
        pos = rng.integers(0, nwords * 32, size=30_000)
        pos[rng.random(30_000) < 0.1] = sent
    return torch.from_numpy(np.asarray(pos, np.uint64).astype(np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("kind", [
    "empty", "all_sentinels", "past_nwords", "ragged", "one_position",
    "partial_warp", "runs_across_tiles", "in_place_sentinels", "unsorted",
    *TILE_KINDS])
@pytest.mark.parametrize("name", ["scatter_or_sorted",
                                  "scatter_or_sorted_delta"])
def test_sorted_scatter_kernels_match_plain(dev, name, kind):
    from btl_bloomfilter_tpu_torch.kernels import scatter_ring
    fn, plain = {
        "scatter_or_sorted": (scatter_or.scatter_or_sorted,
                              scatter_or.scatter_or_sorted_plain),
        "scatter_or_sorted_delta": (scatter_ring.scatter_or_sorted,
                                    scatter_ring.scatter_or_sorted_plain),
    }[name]
    rng = np.random.default_rng(len(kind))
    nwords = 3 * TILE + 1001 if kind in TILE_KINDS else 5000
    pos = sorted_positions(kind, nwords, rng)
    start = random_words(nwords, 3) & 0x00FF00FF
    before = kernels.KERNELS[name].launches
    if kind == "unaligned_view":    # 4 bytes past a 16-byte boundary
        words = torch.empty(nwords + 1, dtype=torch.int32, device=dev)[1:]
        words.copy_(start.to(dev))
        assert words.data_ptr() % 16 == 4
    else:
        words = start.to(dev)
    pos_dev = pos.to(dev)
    if kind == "unaligned_positions":   # a view 4 bytes past 16
        pos_dev = torch.empty(pos.numel() + 1, dtype=torch.int32,
                              device=dev)[1:]
        pos_dev.copy_(pos.to(dev))
    got, over = fn(words, pos_dev, pos_for_base=pos_dev)
    ref, _ = plain(start.clone(), pos)
    torch.cuda.synchronize()
    assert over == 0 and torch.equal(got.cpu(), ref)
    assert (got is words) == (name == "scatter_or_sorted")
    if name == "scatter_or_sorted_delta":   # the input filter is untouched
        assert torch.equal(words.cpu(), start)
    assert kernels.KERNELS[name].launches == before + int(pos.numel() > 0)


def sort_keys(kind, n, block, rng):
    if kind == "all_equal":
        x = np.full(n, 0x80000000, np.uint32)
    elif kind == "extremes":
        x = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                                 0xFFFFFFFF], np.uint32), size=n)
    elif kind == "descending":
        x = np.sort(rng.integers(0, 1 << 32, size=n, dtype=np.uint32))[::-1]
    elif kind == "ascending":       # each block already sorted
        x = np.sort(rng.integers(0, 1 << 32, size=(n // block, block),
                                 dtype=np.uint32), axis=1)
    elif kind == "eight_values":    # long runs of equal keys
        x = rng.choice(np.array([0, 3, 0x7FFFFFFF, 0x80000000, 0x80000001,
                                 0xC0000000, 0xFFFFFFF0, 0xFFFFFFFF],
                                np.uint32), size=n)
    elif kind == "extremes_at_edges":   # at each block's first and last slots
        x = rng.integers(1, 0x7FFFFFFF, size=(n // block, block),
                         dtype=np.uint32)
        x[:, :2] = [0xFFFFFFFF, 0x80000000]
        x[:, -2:] = [0x7FFFFFFF, 0]
    else:
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).ravel())


@pytest.mark.parametrize("kind", ["random", "all_equal", "extremes",
                                  "descending", "ascending", "eight_values",
                                  "extremes_at_edges", "unaligned_view"])
@pytest.mark.parametrize("nblocks", [0, 1, 37, 133, 2048])
@pytest.mark.parametrize("name,block", [("sort_blocks", 2048),
                                        ("chunk_bitonic", 1024)])
def test_block_sort_kernels_match_plain(dev, name, block, nblocks, kind):
    from btl_bloomfilter_tpu_torch.kernels import vmem_sort
    fn = getattr(vmem_sort, name)
    plain = getattr(vmem_sort, name + "_plain")
    x = sort_keys(kind, nblocks * block, block,
                  np.random.default_rng(nblocks))
    before = kernels.KERNELS[name].launches
    if kind == "unaligned_view":    # 4 bytes past a 16-byte boundary
        x_dev = torch.empty(x.numel() + 1, dtype=torch.int32,
                            device=dev)[1:]
        x_dev.copy_(x.to(dev))
    else:
        x_dev = x.to(dev)
    got = fn(x_dev)
    ref = plain(x)
    assert torch.equal(got.cpu(), ref)
    assert kernels.KERNELS[name].launches == before + int(nblocks > 0)
    u = ref.numpy().view(np.uint32).reshape(-1, block) if nblocks else None
    assert u is None or (np.diff(u.astype(np.int64), axis=1) >= 0).all()


@pytest.mark.parametrize("nwin", [1, 3, 6, 300])
@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("kind", ["uniform", "last_window", "sentinels",
                                  "bad_chunks", "all_invalid",
                                  "repeated_slots", "dropped"])
def test_window_scatter_kernel_matches_plain(dev, kind, slots, nwin):
    """Fewer windows than the sweep's persistent grid (1, 3, 6) and more
    (300); chunk indices past either end, every one invalid, or one chunk
    in every slot; positions that no chunk of their window reaches."""
    from btl_bloomfilter_tpu_torch.kernels import window_scatter
    from btl_bloomfilter_tpu_torch.probes import kernel_lab
    win, chunk = window_scatter.WIN_WORDS, window_scatter.CHUNK
    rng = np.random.default_rng(slots * nwin)
    n = max(8, 2 * nwin) * chunk
    nwords = nwin * win
    top = nwords * 32
    if kind == "last_window":       # down to the filter's very last bit
        pos = rng.integers(top - win * 32, top, size=n)
        pos[:5] = top - 1
    elif kind == "sentinels":       # past the filter, then sentinels
        pos = rng.integers(0, top + 4000, size=n)
        pos[: n // 2] = 0xFFFFFFFF
    else:
        pos = rng.integers(0, top, size=n)
    pos = torch.from_numpy(np.sort(pos.astype(np.uint64)).astype(np.uint32)
                           .view(np.int32))
    # with 1 slot, uniform positions spill past their window's chunk
    idx = kernel_lab.chunk_index(pos, 1 if kind == "dropped" else slots,
                                 nwords)
    if kind == "bad_chunks":
        idx[0, ::2] = -1
        idx[-1, 1::3] = n // chunk
    elif kind == "all_invalid":
        idx[:, ::2] = -1
        idx[:, 1::2] = n // chunk
    elif kind == "repeated_slots":
        idx[:] = idx[:1]
    start = random_words(nwords, 5) & 0x0F0F0F0F
    for scatter in (False, True):
        before = window_scatter.KERNEL.launches
        got = window_scatter.window_scatter(idx.to(dev), pos.to(dev),
                                            start.to(dev), scatter)
        ref = window_scatter.window_scatter_plain(idx, pos, start.clone(),
                                                  scatter)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref)
        assert window_scatter.KERNEL.launches == before + 1
    if kind == "last_window":
        assert bool((ref[-win:] != start[-win:]).any())
    elif kind == "all_invalid":
        assert torch.equal(ref, start)
    elif kind == "dropped":         # some positions reached no chunk
        full = scatter_or.scatter_or_plain(start.clone(), pos)
        assert not torch.equal(ref, full)


@pytest.mark.parametrize("nsteps,k,rows", [
    (0, 3, 2), (1, 1, 1), (3, 7, 3), (5, 16, 8), (2, 255, 1),
    (3, 5, 40),          # 20 KiB chunks
    (2, 3, 32),          # 16 KiB chunks
    (7, 100, 150),       # past L2: steps split over blocks, unevenly
] + [(partition_probe.NSTEPS, k, rows)          # the probe's sweeps, whole
     for k, rows in partition_probe.SWEEPS])
def test_dma_sweep_kernel_matches_plain(dev, nsteps, k, rows):
    from btl_bloomfilter_tpu_torch.kernels import dma_sweep
    copy, src = partition_probe.dma_sweep(nsteps, k, rows, device=dev,
                                          seed=k)
    before = dma_sweep.KERNEL.launches
    got = copy(src)
    torch.cuda.synchronize()
    assert got.data_ptr() != src.data_ptr() or nsteps == 0
    assert torch.equal(got, src)
    assert torch.equal(got.cpu(), dma_sweep.sweep_copy_plain(src.cpu(), k,
                                                             rows))
    assert dma_sweep.KERNEL.launches == before + int(nsteps > 0)


@pytest.mark.parametrize("form", ["insert_and_check",
                                  "insert_and_check_sequential"])
def test_insert_and_check_on_cuda_matches_cpu(dev, form):
    rng = np.random.default_rng(11)
    hashes = rng.integers(0, 1 << 64, size=(40, 60, 4), dtype=np.uint64)
    hashes[3, 5, 1] = hashes[3, 5, 0]
    hashes[20:] = hashes[:20]               # repeated frames
    valid = torch.from_numpy(rng.random((40, 60)) < 0.9)
    fn = getattr(bloom, form)
    out = []
    kernels.reset_launch_counts()
    for device in (dev, torch.device("cpu")):
        bf = bloom.create(50_000, 4, 21, device=device)
        found = [fn(bf, u64.from_numpy(hashes[:10]), valid[:10])[1],
                 fn(bf, u64.from_numpy(hashes), valid)[1]]
        out.append((bf.words.cpu(), [f.cpu() for f in found]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    counts = kernels.launch_counts()
    # a 50,000-bit filter takes the direct route
    assert counts["gather_words"] == 2 and counts["scatter_or"] == 2
    assert counts["scatter_or_tiled"] == 0
    if form == "insert_and_check_sequential":
        again = valid[20:] & valid[:20]     # both copies valid
        assert bool(out[0][1][1][20:][again].all())


# ---------------------------------------------------------------------------
# wide positions (int64, sentinel -1): Bloom filters from 2**32 bits
# ---------------------------------------------------------------------------

# 2**32 (0xFFFFFFFF a real position), 2**34 (the tiled route's largest
# filter, MAX_TILES tiles) and write_bloom's sizing of a 3.1e9-byte FASTA
# at -p 0.0001 (113,349 tiles: the direct route only)
WIDE_SIZES = [1 << 32, 1 << 34, 59_427_361_984]


def wide_positions(size, shape, seed):
    """int64 positions < size + 5000 (some past the filter), whole windows
    (axis 0 = slots) and stray slots set to -1, and positions whose low 32
    bits are 0xFFFFFFFF, the narrow form's sentinel."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, size + 5000, size=shape, dtype=np.int64)
    pos[:, rng.random(shape[1:]) < 0.05] = -1
    pos[rng.random(shape) < 0.01] = -1
    lows = np.arange(0xFFFFFFFF, size, 1 << 32)
    pos.reshape(-1)[1:1 + 40 * lows.size] = np.repeat(lows, 40)
    return torch.from_numpy(pos)


@pytest.mark.parametrize("h", [4, 13])
@pytest.mark.parametrize("size", WIDE_SIZES)
def test_nthash_wide_matches_plain(dev, size, h):
    """The positions mode's wide instantiation on a 2%-N batch."""
    codes = random_codes(64, 2048, 0.02, size % 1001 + h).to(dev)
    before = nthash_scan.WIDE_KERNEL.launches
    got = nthash_scan.positions_planes(codes, 31, h, size)
    assert nthash_scan.WIDE_KERNEL.launches == before + 1
    assert got[0].dtype == torch.int64
    for a, b in zip(got, nthash_scan.positions_planes_plain(codes, 31, h,
                                                             size)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size,route", [
    (1 << 32, "direct"), (1 << 32, "tiled"), (1 << 34, "direct"),
    (1 << 34, "tiled"), (59_427_361_984, "direct")])
def test_scatter_or_wide_routes_match_plain(dev, size, route):
    nwords = (size + 31) // 32
    pos = wide_positions(size, (13, 400_000), size % 997).to(dev)
    start = torch.randint(-(1 << 31), 1 << 31, (nwords,), dtype=torch.int32,
                          device=dev) & 0x01010101
    kernel = {"direct": scatter_or.WIDE_KERNEL,
              "tiled": scatter_or.TILED_WIDE_KERNEL}[route]
    before = kernel.launches
    got = getattr(scatter_or, f"scatter_or_{route}")(start.clone(), pos)
    assert kernel.launches == before + 1
    ref = scatter_or.scatter_or_plain(start, pos)
    assert torch.equal(got, ref)


def test_scatter_or_wide_tiled_refuses_past_max_tiles(dev):
    nwords = (tile_partition.MAX_TILES << tile_partition.TILE_SHIFT) + 1
    words = torch.zeros(nwords, dtype=torch.int32, device=dev)
    assert scatter_or.route(nwords, 1 << 26) == "direct"
    with pytest.raises(ValueError):
        scatter_or.scatter_or_tiled(words, torch.zeros(
            10, dtype=torch.int64, device=dev))


def wide_canonical(offsets, grouped, word_shift):
    """The grouped positions put back together from their tile and low 32
    bits, sorted within the whole: the grouping with the free order inside
    a tile taken out."""
    total = int(offsets[-1])
    tiles = torch.repeat_interleave(
        torch.arange(offsets.numel() - 1, device=offsets.device),
        (offsets[1:] - offsets[:-1]).long())
    span = tile_partition.TILE_SHIFT + word_shift
    low = grouped[:total].to(torch.int64) & ((1 << span) - 1)
    return offsets, torch.sort((tiles << span) | low).values


@pytest.mark.parametrize("size", [(1 << 25) + 96, 1 << 32, 1 << 34])
def test_tile_partition_wide_matches_plain(dev, size):
    """One scatter pass (65 tiles) and two (8192 and MAX_TILES tiles), on
    positions with a hot one and low bits equal to 0xFFFFFFFF."""
    nwords = (size + 31) // 32
    pos = wide_positions(size, (13, 300_000), size % 991).to(dev)
    pos.view(-1)[100_000:150_000] = pos.view(-1)[7]
    before = tile_partition.WIDE_KERNEL.launches
    got = tile_partition.tile_partition(pos, nwords, 5)
    assert tile_partition.WIDE_KERNEL.launches == before + 1
    ref = tile_partition.tile_partition_plain(pos, nwords, 5)
    g_off, g_pos = wide_canonical(*got, 5)
    r_off, r_pos = wide_canonical(*ref, 5)
    assert torch.equal(g_off, r_off) and torch.equal(g_pos, r_pos)


@pytest.mark.parametrize("h", [4, 13])
@pytest.mark.parametrize("size", WIDE_SIZES)
def test_gather_words_wide_matches_plain(dev, size, h):
    nwords = (size + 31) // 32
    words = torch.randint(-(1 << 31), 1 << 31, (nwords,), dtype=torch.int32,
                          device=dev)
    words |= torch.randint_like(words, -(1 << 31), 1 << 31)
    if h == 13:
        words |= torch.randint_like(words, -(1 << 31), 1 << 31)
    pos = wide_positions(size, (h, 200_000), size % 983 + h).to(dev)
    before = gather_words.WIDE_KERNEL.launches
    got = gather_words.gather_words(words, pos)
    assert gather_words.WIDE_KERNEL.launches == before + 1
    ref = gather_words.gather_words_plain(words, pos)
    assert got.any() and torch.equal(got, ref)


def test_kmer_bloom_wide_on_cuda_matches_cpu(dev):
    """The k-mer wrappers at 2**32 + 1000 bits through the wide kernels."""
    codes = random_codes(16, 700, 0.02, 15)
    size, h, k = (1 << 32) + 1000, 13, 31
    kernels.reset_launch_counts()
    bf_gpu = kmer_bloom.insert_seq(bloom.create(size, h, k, device=dev),
                                   codes)
    bf_cpu = kmer_bloom.insert_seq(bloom.create(size, h, k, device="cpu"),
                                   codes)
    assert torch.equal(bf_gpu.words.cpu(), bf_cpu.words)
    probe = torch.cat([codes[:8], random_codes(8, 700, 0.02, 16)])
    hit_g, valid_g = kmer_bloom.contains_seq(bf_gpu, probe)
    hit_c, valid_c = kmer_bloom.contains_seq(bf_cpu, probe)
    assert torch.equal(hit_g.cpu(), hit_c) and torch.equal(valid_g.cpu(),
                                                           valid_c)
    counts = kernels.launch_counts()
    assert counts["nthash_scan_wide"] == 2 and counts["nthash_scan"] == 0
    assert counts["scatter_or_wide"] == 1 and counts["gather_words_wide"] == 1
    assert counts["scatter_or"] == counts["gather_words"] == 0


# ---------------------------------------------------------------------------
# the spaced-seed MIBF path: spaced_scan and mibf_random_insert
# ---------------------------------------------------------------------------

def seeds_of(k, m, seed, zfrac=0.2):
    """m seeds of length k with about zfrac of their columns '0'."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        s = np.array(list("1" * k))
        if k > 1:
            s[rng.choice(k, size=max(1, int(k * zfrac)), replace=False)] = "0"
        out.append("".join(s))
    return out


SPACED = [  # B, L, k, seeds, m2, nfrac, fraction of '0' columns
    (2, 40, 1, 1, 2, 0.05, 0.2),
    (3, 300, 9, 2, 3, 0.1, 0.2),        # k < the run (16 windows)
    (4, 31, 31, 2, 2, 0.0, 0.2),        # one window a read
    (3, 40, 31, 2, 2, 0.05, 0.2),       # W = 10 < the run
    (5, 2048, 31, 4, 3, 0.02, 0.2),
    (3, 2048 + 30 + 300, 31, 2, 2, 0.02, 0.2),  # W not a multiple of TILE
    (2, 4096 + 63 + 33, 64, 1, 2, 0.01, 0.3),   # runs of 32, a ragged tile
    (3, 700, 129, 1, 1, 0.002, 0.2),
    (2, 800, 700, 2, 2, 0.0002, 0.2),   # masked rows past 48 KB with the
    (2, 3100, 3000, 1, 2, 0.0, 0.2),    # static arrays
    (2, 3100, 3000, 2, 1, 0.001, 0.5),  # past SHARED_MAX: global memory
]


@pytest.mark.parametrize("B,L,k,m,m2,nfrac,zfrac", SPACED)
def test_spaced_scan_kernel_matches_plain(dev, B, L, k, m, m2, nfrac, zfrac):
    from btl_bloomfilter_tpu_torch.kernels import spaced_scan
    seed_strings = seeds_of(k, m, k + m, zfrac)
    codes = random_codes(B, L, nfrac, B * L + k)
    codes[0, L // 2:] = 4                 # a read padded with N
    for what, c in (("aligned", codes.to(dev)),
                    ("unaligned", torch.cat([codes.new_zeros(1).to(dev),
                                             codes.reshape(-1).to(dev)])
                     [1:].view(B, L))):
        before = spaced_scan.KERNEL.launches
        got = spaced_scan.spaced_frames_planes(c, seed_strings, m2)
        assert spaced_scan.KERNEL.launches == before + 1
        ref = spaced_scan.spaced_frames_planes_plain(c, seed_strings, m2)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, what
            assert torch.equal(a, b), what


def test_spaced_scan_refuses_short_reads_and_unequal_seeds(dev):
    from btl_bloomfilter_tpu_torch.kernels import spaced_scan
    codes = random_codes(2, 8, 0.0, 1).to(dev)
    before = spaced_scan.KERNEL.launches
    with pytest.raises(ValueError):
        spaced_scan.spaced_frames_planes(codes, ["110110111"], 1)
    with pytest.raises(ValueError):
        spaced_scan.spaced_frames_planes(codes, ["1101", "11011"], 1)
    assert spaced_scan.KERNEL.launches == before


RANDOM_CASES = [  # max_count, strand, duplicate frames, h, size
    (1, False, False, 4, 4096),
    (1, True, False, 3, 4096),
    (2, False, True, 4, 4096),
    (3, False, True, 5, 4096),
    (2, True, True, 4, 1 << 20),
    (1, True, True, 1, 1 << 16),        # one slot a frame
    (1, False, False, 300, 1 << 22),    # many slots a frame
]


def random_filter(maxc, use_strand, dup, h, size, width, dev):
    """A filter whose bit vector holds the frames' positions, pre-set and
    pre-saturated entries at max_count 1, and the frames."""
    from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct
    rng = np.random.default_rng(maxc * 100 + h + width)
    n = 2000 if h < 300 else 200
    hashes = rng.integers(0, 1 << 64, size=(n, h), dtype=np.uint64)
    strand = rng.random(hashes.shape) < 0.5 if use_strand else None
    if dup:
        idx = rng.integers(0, n, size=2 * n)
        hashes = hashes[idx]
        strand = None if strand is None else strand[idx]
    hashes = u64.from_numpy(hashes).to(dev)
    st = mibf_construct.BitVectorState(
        bv_words=torch.zeros(size // 32, dtype=torch.int32, device=dev),
        filter_size=size, kmer_size=5, hash_num=h, occupancy=0.5, sseeds=())
    mibf_construct.insert_bv(st, hashes)
    m, _ = mibf_construct.get_empty_mibf(st, width)
    if maxc == 1:
        d = m.data.cpu().numpy()
        d[rng.integers(0, len(d), size=len(d) // 3)] = 5
        d[rng.integers(0, len(d), size=len(d) // 7)] = (m.s_mask | 5) - (
            (1 << 8 * width) if width > 1 else 0)
        m.data.copy_(torch.from_numpy(d))
    valid = torch.from_numpy(rng.random(hashes.shape[0]) < 0.9).to(dev)
    return m, hashes, None if strand is None else \
        torch.from_numpy(strand).to(dev), valid


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("maxc,use_strand,dup,h,size", RANDOM_CASES)
def test_mibf_random_insert_kernel_matches_plain(dev, maxc, use_strand, dup,
                                                 h, size, width):
    from btl_bloomfilter_tpu_torch.kernels import mibf_random_insert as ri
    from btl_bloomfilter_tpu_torch.models import mibf_construct
    m, hashes, strand, valid = random_filter(maxc, use_strand, dup, h, size,
                                             width, dev)
    for v in (None, valid):
        args = (m.bv_words, m.cum_ranks, m.rank_dir)
        a, b = m.data.clone(), m.data.clone()
        before = ri.KERNEL.launches
        got = ri.random_insert(*args, a, hashes, size, 0x1234567, maxc,
                               strand, v)
        assert ri.KERNEL.launches == before + 1
        ref = ri.random_insert_plain(*args, b, hashes, size, 0x1234567, maxc,
                                     strand, v)
        assert torch.equal(got, ref) and torch.equal(a, b)
        assert got.any() and not torch.equal(a, m.data)
    # the host mirror (no frame mask) on the host
    host = mibf_construct.insert_random_order(
        dataclasses.replace(m, data=m.data.cpu(), bv_words=m.bv_words.cpu(),
                            cum_ranks=m.cum_ranks.cpu()), hashes.cpu(),
        0x1234567 & m.width_mask, maxc,
        None if strand is None else strand.cpu())
    a = m.data.clone()
    got = ri.random_insert(m.bv_words, m.cum_ranks, m.rank_dir, a, hashes,
                           size, 0x1234567 & m.width_mask, maxc, strand)
    assert torch.equal(a.cpu(), host[0].data)
    assert np.array_equal(got.cpu().numpy(), host[1])


RANDOM_SCHEDULES = ["one_kmer", "repeats", "unset_bits", "past_last_bit",
                    "repeated_slots", "invalid_interleaved"]


def schedule_filter(kind, width, dev, n=3000):
    """A filter and frames (h = 4) on which the kernel's rounds and tail
    take the path ``kind`` names: every frame one k-mer (frame 0 in a
    round, the rest in the tail), frames repeated 2-64 times at random
    places, slots whose bit is unset (below the last set bit, so ranks
    alias), slots past the last set bit (rank d_size, clamped reads),
    frames whose slots repeat a key, and interleaved invalid frames.
    Returns (m, hashes, strand, valid, max_count, host) with ``host``
    False where the host mirror is undefined (ranks past the ID array)."""
    from btl_bloomfilter_tpu_torch.models import mibf_construct
    rng = np.random.default_rng(RANDOM_SCHEDULES.index(kind) * 7 + width)
    size, h = 1 << 16, 4
    distinct = rng.integers(0, 1 << 64, size=(n // 8, h), dtype=np.uint64)
    built, strand, valid, maxc = distinct, None, None, 1
    if kind == "one_kmer":
        hashes = np.repeat(distinct[:1], n, axis=0)
        strand = np.repeat(rng.random((1, h)) < 0.5, n, axis=0)
    elif kind == "repeats":
        idx = np.repeat(np.arange(n // 33), rng.integers(2, 65,
                                                          size=n // 33))
        hashes = distinct[rng.permutation(idx)]
        maxc = 2
    elif kind == "unset_bits":
        last = int((distinct % np.uint64(size)).max())
        hashes = rng.integers(0, last, size=(n // 2, h), dtype=np.uint64)
        hashes = hashes[rng.integers(0, n // 2, size=n)]
        strand = rng.random(hashes.shape) < 0.5
    elif kind == "past_last_bit":
        built = rng.integers(0, size // 2, size=(n // 8, h), dtype=np.uint64)
        hashes = np.where(rng.random((n, h)) < 0.4,
                          rng.integers(size // 2, size, size=(n, h),
                                       dtype=np.uint64),
                          built.reshape(-1)[rng.integers(
                              0, built.size, size=(n, h))])
        maxc = 2
    elif kind == "repeated_slots":
        hashes = distinct[rng.integers(0, len(distinct), size=n)].copy()
        hashes[:, 2] = hashes[:, 0]
        hashes[::3, 3] = hashes[::3, 1]
        strand = rng.random(hashes.shape) < 0.5
    else:
        hashes = distinct[rng.integers(0, len(distinct), size=n)]
        strand = rng.random(hashes.shape) < 0.5
        valid = rng.random(n) < 0.7
    st = mibf_construct.BitVectorState(
        bv_words=torch.zeros(size // 32, dtype=torch.int32, device=dev),
        filter_size=size, kmer_size=5, hash_num=h, occupancy=0.5, sseeds=())
    mibf_construct.insert_bv(st, u64.from_numpy(built).to(dev))
    m, _ = mibf_construct.get_empty_mibf(st, width)
    if maxc == 1 and kind != "one_kmer":
        d = m.data.cpu().numpy()
        d[rng.integers(0, len(d), size=len(d) // 3)] = 5
        d[rng.integers(0, len(d), size=len(d) // 7)] = (m.s_mask | 5) - (
            (1 << 8 * width) if width > 1 else 0)
        m.data.copy_(torch.from_numpy(d))
    return (m, u64.from_numpy(hashes).to(dev),
            None if strand is None else torch.from_numpy(strand).to(dev),
            None if valid is None else torch.from_numpy(valid).to(dev),
            maxc, kind != "past_last_bit")


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("kind", RANDOM_SCHEDULES)
def test_mibf_random_insert_schedules_match_plain(dev, kind, width):
    """The kernel's rounds and tail on frames that force each path: IDs
    and success equal the plain version's and (where defined, without a
    frame mask) the host mirror's; the kernel's round count, frames run in
    rounds and tail length equal round_schedule's."""
    from btl_bloomfilter_tpu_torch.kernels import mibf_random_insert as ri
    from btl_bloomfilter_tpu_torch.models import mibf_construct
    m, hashes, strand, valid, maxc, host = schedule_filter(kind, width, dev)
    args = (m.bv_words, m.cum_ranks, m.rank_dir)
    a, b = m.data.clone(), m.data.clone()
    got_s = torch.zeros(3, dtype=torch.int32, device=dev)
    ref_s = torch.zeros(3, dtype=torch.int32)
    before = ri.KERNEL.launches
    got = ri.random_insert(*args, a, hashes, m.size, 9, maxc, strand, valid,
                           schedule=got_s)
    assert ri.KERNEL.launches == before + 1
    ref = ri.random_insert_plain(*args, b, hashes, m.size, 9, maxc, strand,
                                 valid, schedule=ref_s)
    assert torch.equal(got, ref) and torch.equal(a, b)
    assert got_s.tolist() == ref_s.tolist()
    if kind == "one_kmer":
        assert got_s.tolist() == [1, 1, hashes.shape[0] - 1]
    if host and valid is None:
        hm = mibf_construct.insert_random_order(
            dataclasses.replace(m, data=m.data.cpu(),
                                bv_words=m.bv_words.cpu(),
                                cum_ranks=m.cum_ranks.cpu()),
            hashes.cpu(), 9, maxc, None if strand is None else strand.cpu())
        assert torch.equal(a.cpu(), hm[0].data)
        assert np.array_equal(got.cpu().numpy(), hm[1])
