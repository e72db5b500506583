"""The tile partition (``kernels/tile_partition.py``) and the tiled routes of
the two scatters, on the CPU: the partition's plain version against a numpy
bucketing; the tiled algorithm's plain model (partition, then apply tile by
tile, each tile rebased to its own words as a block of the tiled route
holds it) against the JAX package's Bloom insert and its scatter_add
kernels in interpret mode; and the route rules as pure functions at the
shapes the main paths give them.

Inputs are made with numpy from fixed seeds and handed to both sides; all
compared outputs are integers, so the tolerance is zero.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.kernels import scatter_add as jax_scatter_add
from btl_bloomfilter_tpu.kernels import scatter_or as jax_scatter_or
from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu_torch.kernels import (_build, scatter_add,
                                               scatter_or, tile_partition)

torch.set_num_threads(1)

SENT = 0xFFFFFFFF
NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}
jax_insert_sentinel_positions = jax.jit(jax_bloom.insert_sentinel_positions,
                                        static_argnames=("use_kernel",))


def as_i32(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.uint32)
                            .view(np.int32).copy())


def positions(kind, nwords, word_shift, tile_shift, rng, n=5000):
    """uint64 positions of one case for an array of nwords words."""
    if kind == "empty":
        return np.zeros(0, np.uint64)
    if kind == "all_sentinels":
        return np.full(300, SENT, np.uint64)
    limit = min((nwords << word_shift) + 3000, 1 << 32)
    pos = rng.integers(0, limit, size=n, dtype=np.uint64)
    pos[rng.random(n) < 0.1] = SENT
    if kind == "last_tile":     # the ragged last tile, past-array positions
        first = ((nwords - 1) >> tile_shift) << tile_shift
        pos[: n // 2] = rng.integers(first << word_shift,
                                     nwords << word_shift, size=n // 2)
    return pos


def numpy_bucketing(pos, nwords, word_shift, tile_shift):
    """Tile -> sorted list of its live positions."""
    ntiles = -(-nwords >> tile_shift)
    out = {t: [] for t in range(ntiles)}
    for p in pos:
        p = int(p)
        if p == SENT or (p >> word_shift) >= nwords:
            continue
        out[(p >> word_shift) >> tile_shift].append(p)
    return {t: sorted(v) for t, v in out.items()}


CASES = [  # nwords, word_shift, tile_shift
    (1, 5, 14), (37, 5, 2), (1000, 2, 4), (4097, 0, 6), (1 << 12, 5, 7)]


@pytest.mark.parametrize("kind", ["random", "empty", "all_sentinels",
                                  "last_tile"])
@pytest.mark.parametrize("shape", ["flat", "planes"])
@pytest.mark.parametrize("nwords,word_shift,tile_shift", CASES)
def test_tile_partition_plain_matches_numpy(kind, shape, nwords, word_shift,
                                            tile_shift):
    """Positions flat or as [4, rows, cols] planes: a partition takes any
    shape."""
    rng = np.random.default_rng(nwords + 7 * word_shift + tile_shift)
    pos = positions(kind, nwords, word_shift, tile_shift, rng)
    t = as_i32(pos)
    if shape == "planes" and pos.size:
        t = t.reshape(4, -1, 25)
    offsets, grouped = tile_partition.tile_partition_plain(
        t, nwords, word_shift, tile_shift)
    ref = numpy_bucketing(pos, nwords, word_shift, tile_shift)
    counts = [len(ref[t]) for t in range(len(ref))]
    assert offsets.tolist() == np.concatenate([[0], np.cumsum(counts)]
                                              ).tolist()
    g = grouped.numpy().view(np.uint32).astype(np.int64)
    for tile, want in ref.items():
        lo, hi = int(offsets[tile]), int(offsets[tile + 1])
        assert sorted(int(g[i]) for i in range(lo, hi)) == want
    total = int(offsets[-1])
    assert (grouped[total:] == -1).all()
    assert grouped.shape == (pos.size,)


def test_tile_partition_refuses_too_many_tiles():
    pos = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tile_partition.tile_partition_plain(
            pos, tile_partition.MAX_TILES + 1, 0, 0)
    with pytest.raises(ValueError):
        tile_partition.tile_partition_plain(pos, 0, 0, 0)
    with pytest.raises(ValueError):
        tile_partition.tile_partition(
            pos, (tile_partition.MAX_TILES << tile_partition.TILE_SHIFT) + 1,
            0)


def test_tile_constants_match_the_source():
    """The wrapper reads the tile constants from the CUDA header: a tile of
    64 KiB, and the 2**15 tiles of the partition's two passes of 8 and 7
    bits (a 2**30-counter u8 filter has 16384 tiles)."""
    with open(os.path.join(_build.CSRC, "tile_partition.cuh")) as f:
        src = f.read()
    assert re.search(rf"^#define BTL_TILE_SHIFT {tile_partition.TILE_SHIFT}$",
                     src, re.M)
    assert re.search(rf"^#define BTL_MAX_TILES {tile_partition.MAX_TILES}$",
                     src, re.M)
    assert 4 << tile_partition.TILE_SHIFT == 64 * 1024
    assert tile_partition.MAX_TILES == 1 << (8 + 7)
    assert tile_partition.ntiles(1 << 28) == 16384


# ---------------------------------------------------------------------------
# the tiled algorithm's plain model against the JAX package
# ---------------------------------------------------------------------------

def tiled_scatter_or(words, pos, tile_shift):
    """Partition, then OR each tile's positions into a copy of its words
    (positions rebased to the tile), as a block of the tiled route holds
    it."""
    offsets, grouped = tile_partition.tile_partition_plain(
        pos, words.numel(), 5, tile_shift)
    for t in range(offsets.numel() - 1):
        lo, hi = int(offsets[t]), int(offsets[t + 1])
        w0 = t << tile_shift
        tile = words[w0:w0 + (1 << tile_shift)].clone()
        rebased = (grouped[lo:hi].to(torch.int64) & 0xFFFFFFFF) - w0 * 32
        scatter_or.scatter_or_plain(tile, rebased.to(torch.int32))
        words[w0:w0 + tile.numel()] = tile
    return words


def tiled_scatter_add(words, pos, shift, cmax, tile_shift):
    """Partition, then add 1 at each of a tile's positions in a copy of its
    words: the tiled route takes unit increments only."""
    offsets, grouped = tile_partition.tile_partition_plain(
        pos, words.numel(), shift, tile_shift)
    for t in range(offsets.numel() - 1):
        lo, hi = int(offsets[t]), int(offsets[t + 1])
        w0 = t << tile_shift
        tile = words[w0:w0 + (1 << tile_shift)].clone()
        rebased = ((grouped[lo:hi].to(torch.int64) & 0xFFFFFFFF)
                   - (w0 << shift))
        scatter_add.scatter_add_plain(tile, rebased.to(torch.int32), shift,
                                      cmax)
        words[w0:w0 + tile.numel()] = tile
    return words


@pytest.mark.parametrize("size,tile_shift", [
    (1000, 2), ((1 << 14) + 96, 5), (3 * (1 << 11) * 32 - 64, 11),
    ((1 << 20) - 64, 14)])
def test_tiled_scatter_or_model_matches_jax(size, tile_shift):
    """Sentinels, duplicates and a ragged last tile (sizes that are not a
    multiple of a tile's bits)."""
    rng = np.random.default_rng(size % 101)
    pos = rng.integers(0, size, size=(4, 12, 300), dtype=np.uint64)
    pos[:, rng.random((12, 300)) < 0.2] = SENT
    pos[:, :2] = pos[:, 2:4]                           # repeated windows
    pos = pos.astype(np.uint32)
    ref = jax_insert_sentinel_positions(jax_bloom.create(size, 4, 31),
                                        jnp.asarray(pos))
    words = torch.zeros(-(-size // 32), dtype=torch.int32)
    got = tiled_scatter_or(words, as_i32(pos), tile_shift)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref.words))


def packed(counters):
    words = np.frombuffer(counters.astype(counters.dtype.newbyteorder("<"))
                          .tobytes(), dtype="<u4").astype(np.uint32)
    return jnp.asarray(words), torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("width", [1, 2, 4])
def test_tiled_scatter_add_model_matches_jax_kernel(width):
    """Unit saturating adds into one JAX kernel window of counters through
    the tiled model (tiles of 2**9 words), with duplicates, sentinels and
    a hot counter driven past counter_max; and the public wrapper's
    weighted adds (the direct route) against the weighted JAX kernel."""
    rng = np.random.default_rng(20 + width)
    per = 4 // width
    shift = {4: 2, 2: 1, 1: 0}[per]
    ncounters = jax_scatter_or.WIN_WORDS * per
    cmax = (1 << (8 * width)) - 1
    counters = rng.integers(0, min(cmax, 250), size=ncounters).astype(
        NP_DTYPE[width])
    idx = rng.integers(0, ncounters, size=3000, dtype=np.uint32)
    idx[:300] = idx[0]
    counters[idx[0]] = cmax - 5
    vals = rng.integers(0, min(cmax, 300), size=3000, dtype=np.uint32)
    vals[1000:1200] = 0
    order = np.argsort(idx)

    jw, tw = packed(counters)
    ref, _ = jax_scatter_add.scatter_add_sorted(
        jw, jnp.asarray(np.sort(idx)), per, cmax, interpret=True)
    with_sentinels = np.concatenate([idx, np.full(50, SENT, np.uint32)])
    got = tiled_scatter_add(tw, as_i32(with_sentinels), shift, cmax, 9)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))
    assert int(np.asarray(ref).view(NP_DTYPE[width])[idx[0]]) == cmax

    jw, tw = packed(counters)
    ref, ovf = jax_scatter_add.scatter_add_weighted_sorted(
        jw, jnp.asarray(idx[order]), jnp.asarray(vals[order]), per, cmax,
        interpret=True)
    assert (np.asarray(ovf) == SENT).all()
    got = scatter_add.scatter_add(tw, as_i32(idx), shift, cmax,
                                  as_i32(vals))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

BLOOM_BENCH = (1 << 25, 4 * 512 * 2018)       # 2**30 bits, ACGT batch
COUNTING_BENCH = (1 << 28, 4 * 3072 * 2018)   # 2**30 u8 counters
MIBF_7B = (1 << 23, 4 * 63 * (16384 - 30))    # 2**28-bit vector
MIBF_7C = (96817664 // 32, 4 * (262144 - 30))


def test_scatter_or_route_rule():
    assert scatter_or.route(*BLOOM_BENCH) == "tiled"
    assert scatter_or.route(*MIBF_7B) == "direct"
    assert scatter_or.route(*MIBF_7C) == "direct"
    assert scatter_or.route(1, 10**6) == "direct"
    assert scatter_or.route(((1 << 32) - 64) // 32, BLOOM_BENCH[1]) \
        == "tiled"
    assert scatter_or.route(BLOOM_BENCH[0], 1000) == "direct"
    # the grid readings the constants come from: 2M positions tiled up to
    # 2**26 words, 2**27 words from 3M (one position in 48 words), 1.5M
    # direct
    assert scatter_or.route(1 << 24, 3 << 20) == "tiled"
    assert scatter_or.route(1 << 26, 2 << 20) == "tiled"
    assert scatter_or.route(1 << 27, 2 << 20) == "direct"
    assert scatter_or.route(1 << 27, 3 << 20) == "tiled"
    assert scatter_or.route(1 << 25, 3 << 19) == "direct"


def test_scatter_add_route_rule():
    assert scatter_add.route(*COUNTING_BENCH) == "tiled"
    # weighted adds take the direct route whatever the shape
    assert scatter_add.route(*COUNTING_BENCH, weighted=True) == "direct"
    # the grid readings the constants come from: from 2M pairs tiled up to
    # 16 words a pair, 1.5M pairs direct
    assert scatter_add.route(1 << 25, 3 << 20) == "tiled"
    assert scatter_add.route(1 << 26, 3 << 20) == "direct"
    assert scatter_add.route(1 << 26, 1 << 22) == "tiled"
    assert scatter_add.route(1 << 24, 2 << 20) == "tiled"
    assert scatter_add.route(1 << 26, 2 << 20) == "direct"
    assert scatter_add.route(1 << 24, 3 << 19) == "direct"
    assert scatter_add.route(1, 10**6) == "direct"
    assert scatter_add.route(1 << 22, 1000) == "direct"
    # a 2**24-counter u8 filter: the sweep for a whole batch, the direct
    # CAS for 128 reads of one
    assert scatter_add.route(1 << 22, COUNTING_BENCH[1]) == "tiled"
    assert scatter_add.route(1 << 22, 4 * 128 * 2018) == "direct"
    # a 2**30-counter filter and a quarter of a batch: too few pairs for
    # the sweep of 1 GiB
    assert scatter_add.route(1 << 28, COUNTING_BENCH[1] // 4) == "direct"
    # past the partition's tiles, the direct route
    assert scatter_add.route(1 << 30, COUNTING_BENCH[1]) == "direct"
    assert scatter_add.route(*COUNTING_BENCH[:1], 1 << 31) == "direct"


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_both_routes_take_the_plain_version_on_the_cpu(shift):
    rng = np.random.default_rng(shift)
    nwords = 777
    start = torch.from_numpy(rng.integers(0, 1 << 32, size=nwords,
                                          dtype=np.uint64).astype(np.uint32)
                             .view(np.int32).copy())
    pos = as_i32(rng.integers(0, (nwords << shift) + 50, size=4000))
    inc = as_i32(rng.integers(0, 9, size=4000))
    cmax = (1 << (32 >> shift)) - 1
    ref = scatter_add.scatter_add_plain(start.clone(), pos, shift, cmax, inc)
    for fn in (scatter_add.scatter_add_direct, scatter_add.scatter_add):
        assert torch.equal(fn(start.clone(), pos, shift, cmax, inc), ref)
    ref = scatter_add.scatter_add_plain(start.clone(), pos, shift, cmax)
    for fn in (scatter_add.scatter_add_direct, scatter_add.scatter_add_tiled,
               scatter_add.scatter_add):
        assert torch.equal(fn(start.clone(), pos, shift, cmax), ref)
    bits = as_i32(rng.integers(0, nwords * 32 + 50, size=4000))
    ref = scatter_or.scatter_or_plain(start.clone(), bits)
    for fn in (scatter_or.scatter_or_direct, scatter_or.scatter_or_tiled,
               scatter_or.scatter_or):
        assert torch.equal(fn(start.clone(), bits), ref)
