"""incrementAll's sparse route (``scatter_add.scatter_add_sparse``, wide
positions past the partition's tile cap) on the CPU: the coarse tiles it
partitions by; its first stage, the port's tile partition called on
coarse tiles as the route calls it, with the grouped positions added by
the port against the JAX package's scatter_add kernel in interpret mode
(small sizes, through a small tile shift and cap) and, at 2**32 u8
counters, where JAX stops short of counter 2**32 - 1, against the
positions themselves; the CPU fallback; and the route rules as pure
functions at the wide sizes.

The sparse apply has no CPU form: on the CPU ``scatter_add_sparse`` takes
the plain version. The card tests in ``tests/test_torch_cuda_kernels.py``
(``test_scatter_add_sparse_at_2_32_counters``) hold the kernel against it.

Inputs are made with numpy from fixed seeds and handed to both sides; all
compared outputs are integers, so the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.kernels import scatter_add as jax_scatter_add
from btl_bloomfilter_tpu.kernels import scatter_or as jax_scatter_or
from btl_bloomfilter_tpu_torch.kernels import (scatter_add, scatter_or,
                                               tile_partition)

torch.set_num_threads(1)

NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}
GENOME_BITS = 59_427_361_984           # write_bloom's human genome sizing


def coarse_groups(pos, nwords, word_shift, tile_shift=tile_partition.
                  TILE_SHIFT, max_tiles=tile_partition.MAX_TILES):
    """The sparse route's first stage on the CPU: the port's partition on
    coarse tiles. Returns the coarse shift and the grouped positions as
    int64, each checked to lie in the coarse tile its offsets give it."""
    extra = tile_partition.coarse_shift(nwords, tile_shift, max_tiles)
    coarse = tile_partition.coarse_words(nwords, extra)
    offsets, grouped = tile_partition.tile_partition_plain(
        pos, coarse, word_shift + extra, tile_shift)
    off = offsets.numpy().astype(np.int64)
    assert off[0] == 0 and (np.diff(off) >= 0).all()
    g = grouped.numpy()[:off[-1]].view(np.uint32).astype(np.int64)
    span = tile_shift + extra + word_shift      # a coarse tile's positions
    tile = np.repeat(np.arange(off.size - 1), np.diff(off))
    assert (g >> span == tile).all()
    return extra, g


def hot_positions(rng, limit, n, last_coarse):
    """int64 positions below limit: uniform ones, a run of one repeated
    position, sentinels, positions past the array inside its last coarse
    word (the partition keeps them, the add drops them) and the last
    position of the array."""
    pos = rng.integers(0, limit, size=n, dtype=np.int64)
    pos[:400] = pos[0]
    pos[600:][rng.random(n - 600) < 0.05] = -1
    pos[-60:-40] = rng.integers(limit, last_coarse, size=20)
    pos[-40:] = limit - 1
    return pos


@pytest.mark.parametrize("nwords,tile_shift,max_tiles,extra", [
    (1, 14, 32768, 0), (tile_partition.MAX_TILES << 14, 14, 32768, 0),
    ((tile_partition.MAX_TILES << 14) + 1, 14, 32768, 1),
    (1 << 30, 14, 32768, 1),                 # 2**32 u8 counters
    (GENOME_BITS // 32, 14, 32768, 2),       # 113,349 tiles
    (1 << 31, 14, 32768, 2),                 # 2**36 bits
    (1 << 32, 14, 32768, 3),                 # 2**32 u32 counters
    (1000, 2, 8, 5), (1000, 2, 250, 0), (1000, 2, 249, 1)])
def test_coarse_shift(nwords, tile_shift, max_tiles, extra):
    """The least extra that brings the coarse tiles under the cap; the
    coarse words' tiles are the array's tiles at the coarse shift."""
    assert tile_partition.coarse_shift(nwords, tile_shift,
                                       max_tiles) == extra
    coarse = tile_partition.coarse_words(nwords, extra)
    assert tile_partition.ntiles(coarse, tile_shift) <= max_tiles
    assert tile_partition.ntiles(coarse, tile_shift) == \
        tile_partition.ntiles(nwords, tile_shift + extra)
    if extra:
        assert tile_partition.ntiles(nwords, tile_shift + extra - 1) \
            > max_tiles


def packed(counters):
    words = np.frombuffer(counters.astype(counters.dtype.newbyteorder("<"))
                          .tobytes(), dtype="<u4").astype(np.uint32)
    return jnp.asarray(words), words


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("tile_shift,max_tiles", [(6, 4), (3, 100)])
def test_coarse_grouping_adds_like_jax_kernel(width, tile_shift, max_tiles):
    """Unit saturating adds into one JAX kernel window of counters: the
    positions grouped by coarse tile (small tile shift and cap), then added
    by the port in their grouped order, equal JAX's scatter_add kernel on
    the valid positions. Duplicates, sentinels, positions past the array
    in its last coarse word, a hot counter driven past counter_max and
    counters already at it."""
    rng = np.random.default_rng(40 + width + tile_shift)
    per = 4 // width
    shift = {4: 2, 2: 1, 1: 0}[per]
    nwords = jax_scatter_or.WIN_WORDS - 3      # a ragged last coarse tile
    ncounters = nwords * per
    cmax = (1 << (8 * width)) - 1
    extra = tile_partition.coarse_shift(nwords, tile_shift, max_tiles)
    last_coarse = tile_partition.coarse_words(nwords, extra) << (extra
                                                                + shift)
    pos = hot_positions(rng, ncounters, 3000, last_coarse)
    counters = rng.integers(0, min(cmax, 250), size=ncounters).astype(
        NP_DTYPE[width])
    counters[pos[0]] = cmax - 5
    counters[pos[500]] = cmax
    jw, words = packed(np.concatenate(
        [counters, np.zeros(3 * per, counters.dtype)]))   # JAX's window
    live = np.sort(pos[(pos >= 0) & (pos < ncounters)]).astype(np.uint32)
    ref, _ = jax_scatter_add.scatter_add_sorted(jw, jnp.asarray(live), per,
                                                cmax, interpret=True)
    got_extra, grouped = coarse_groups(torch.from_numpy(pos), nwords, shift,
                                       tile_shift, max_tiles)
    assert got_extra == extra and grouped.size == (pos >= 0).sum()
    got = scatter_add.scatter_add_sparse(
        torch.from_numpy(words[:nwords].view(np.int32).copy()),
        torch.from_numpy(grouped), shift, cmax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref)[:nwords])
    assert int(np.asarray(ref).view(NP_DTYPE[width])[pos[0]]) == cmax


def test_coarse_grouping_at_2_32_counters():
    """The size the route serves, with the default tile and cap: 2**32 u8
    counters (2**30 words, 65,536 tiles: coarse tiles of 2**15 words).
    Every live position lands once in its coarse tile, counter 2**32 - 1's
    300 pairs in the last; sentinels are dropped (JAX stops short of
    2**32 - 1, so the reference is the positions themselves)."""
    rng = np.random.default_rng(11)
    S = 1 << 32
    pos = rng.integers(0, S, size=20000, dtype=np.int64)
    pos[:300] = S - 1
    pos[300:320] = S - 2
    pos[320:340] = S - 5                     # another word of the tile
    pos[341::97] = -1
    extra, grouped = coarse_groups(torch.from_numpy(pos), 1 << 30, 2)
    assert extra == 1
    np.testing.assert_array_equal(np.sort(grouped), np.sort(pos[pos >= 0]))
    assert (grouped[-340:] >> 17 == (1 << 15) - 1).all()
    assert (grouped == S - 1).sum() == 300


@pytest.mark.parametrize("shift,cmax", [(2, 255), (1, 1000),
                                        (0, 0xFFFFFFFF)])
def test_sparse_route_takes_the_plain_version_on_the_cpu(shift, cmax):
    rng = np.random.default_rng(shift)
    start = torch.from_numpy(rng.integers(0, 1 << 32, size=777,
                                          dtype=np.uint64)
                             .astype(np.uint32).view(np.int32).copy())
    pos = rng.integers(-1, (777 << shift) + 50, size=4000, dtype=np.int64)
    pos[:100] = -1
    t = torch.from_numpy(pos)
    ref = scatter_add.scatter_add_plain(start.clone(), t, shift, cmax)
    assert torch.equal(scatter_add.scatter_add_sparse(start.clone(), t, shift,
                                                      cmax), ref)


GENOME = (GENOME_BITS // 32, 13 * 512 * 2018)   # h = 13, one ACGT batch
COUNTING_2_32 = (1 << 30, 4 * 3072 * 2018)      # 2**32 u8 counters


def test_scatter_or_route_rule_past_the_tiles():
    """The Bloom insert has no sparse route: past MAX_TILES tiles (2**34
    bits) it is direct, one h = 13 batch into a genome-sized filter
    included; up to the cap the tiled and direct routes as before."""
    top = tile_partition.MAX_TILES << tile_partition.TILE_SHIFT
    assert scatter_or.route(*GENOME) == "direct"
    assert scatter_or.route(1 << 30, GENOME[1]) == "direct"      # 2**35
    assert scatter_or.route(top, GENOME[1]) == "tiled"
    assert scatter_or.route(top + 1, GENOME[1]) == "direct"
    # MIBF phase 1 at 2**32 bits: 8192 tiles, a reference a call
    assert scatter_or.route(1 << 27, 4 * (262144 - 30)) == "direct"


def test_scatter_add_route_rule_past_the_tiles():
    """Wide positions past the cap: bench.py's counting batch into 2**32 u8
    counters takes the sparse route; the grid readings: 8M pairs and more
    sparse, 6M direct. Narrow positions past the cap (u8 filters of 2**31
    to 2**32 - 1 counters) and weighted adds stay direct."""
    assert scatter_add.route(*COUNTING_2_32, wide=True) == "sparse"
    assert scatter_add.route(*COUNTING_2_32) == "direct"
    assert scatter_add.route((1 << 30) - 1, COUNTING_2_32[1]) == "direct"
    assert scatter_add.route(*COUNTING_2_32, weighted=True,
                             wide=True) == "direct"
    assert scatter_add.route(COUNTING_2_32[0], 8 << 20, wide=True) == "sparse"
    assert scatter_add.route(COUNTING_2_32[0], 6 << 20, wide=True) == "direct"
    assert scatter_add.route(COUNTING_2_32[0], 4 * 128 * 2018,
                             wide=True) == "direct"
    assert scatter_add.route(1 << 32, 1 << 25, wide=True) == "sparse"
    assert scatter_add.route(COUNTING_2_32[0], 1 << 31, wide=True) == "direct"
