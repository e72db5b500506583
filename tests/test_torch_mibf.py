"""The port's multi-index Bloom filter (plain PyTorch path) against the JAX
package: phase 1 words, freeze (cum_ranks, d_size), ranks, hits and ID
lookups (against the XLA path and the Pallas kernels in interpret mode),
phases 3 and 4 (single sequence and batched, with the entangled-overflow
fallback), the whole 4-phase pipeline, statistics, saturate / set_data,
``.mibf`` / ``.sdsl`` bytes and the sdsl loader's tolerances.

Inputs are made with numpy from fixed seeds and handed to both sides. The
compared outputs are integers, bools or bytes, so the tolerance is zero,
except ``calc_frame_probs``, held within 1e-12 relative (double-precision
arithmetic in the same order on both sides).
"""

import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import api as jax_api
from btl_bloomfilter_tpu.io import mibf_format as jax_mibf_format
from btl_bloomfilter_tpu.kernels import gather_words as jax_gather_words
from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.ops import nthash_tables as jax_tables
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch import api
from btl_bloomfilter_tpu_torch.io import mibf_format, sdsl
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct
from btl_bloomfilter_tpu_torch.ops import u64

torch.set_num_threads(1)

WIDTHS = [1, 2, 4]
NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}

# jitted JAX references: eager JAX dispatches op by op and is slow on the CPU
jax_insert_bv = jax.jit(jax_construct.insert_bv)
jax_insert_mibf = jax.jit(jax_construct.insert_mibf)
jax_insert_mibf_many = jax.jit(jax_construct.insert_mibf_many)
jax_insert_saturation = jax.jit(jax_construct.insert_saturation,
                                static_argnames=("max_entangled",))
jax_insert_saturation_many = jax.jit(jax_construct.insert_saturation_many,
                                     static_argnames=("max_entangled",))


def rand_hashes(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, size=shape,
                                                dtype=np.uint64)


def states(size, h, k=11):
    """(JAX, port) empty phase-1 states of ``size`` bits."""
    return (jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=k, hash_num=h, occupancy=0.5, sseeds=()),
        mibf_construct.BitVectorState(
            bv_words=torch.zeros(size // 32, dtype=torch.int32),
            filter_size=size, kmer_size=k, hash_num=h, occupancy=0.5,
            sseeds=()))


def carry(jm, device="cpu"):
    """The port's copy of a JAX-built filter."""
    return mibf.from_numpy(np.asarray(jm.bv_words), np.asarray(jm.data),
                           size=jm.size, hash_num=jm.hash_num,
                           kmer_size=jm.kmer_size, data_width=jm.data_width,
                           sseeds=jm.sseeds, device=device)


def copy(m, counts):
    """A port filter and counts that later in-place phases leave alone."""
    return dataclasses.replace(m, data=m.data.clone()), counts.clone()


def assert_same(jm, jcounts, m, counts):
    """The port's ID plane and counts equal the JAX arrays."""
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    np.testing.assert_array_equal(
        counts.numpy().view(NP_DTYPE[m.data_width]), np.asarray(jcounts))


def built_pair(width, size=512, h=3, G=5, W=30, seed=41, partial=False):
    """Phase 1 of G sequences on both sides (cross-sequence and in-sequence
    duplicate frames, invalid frames), frozen at ``width``; ``partial``
    leaves a third of the frames out of phase 1, so later phases meet
    positions that miss the bit vector. Returns (hashes, valid, ids, (jax m,
    counts), (port m, counts))."""
    rng = np.random.default_rng(seed)
    hashes = rand_hashes((G, W, h), seed)
    hashes[2, :8] = hashes[0, :8]
    hashes[3, 5] = hashes[3, 4]
    valid = rng.random((G, W)) < 0.9
    p1 = valid & (rng.random((G, W)) < 0.67) if partial else valid
    jst, pst = states(size, h)
    for g in range(G):
        jst = jax_insert_bv(jst, jax_u64.from_numpy(hashes[g]),
                            jnp.asarray(p1[g]))
        mibf_construct.insert_bv(pst, u64.from_numpy(hashes[g]),
                                 torch.from_numpy(p1[g]))
    np.testing.assert_array_equal(pst.bv_words.numpy().view(np.uint32),
                                  np.asarray(jst.bv_words))
    ids = np.arange(1, G + 1, dtype=np.int32)
    return (hashes, valid, ids, jax_construct.get_empty_mibf(jst, width),
            mibf_construct.get_empty_mibf(pst, width))


# ---------------------------------------------------------------------------
# phase 1, freeze, ranks and ID lookups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
def test_freeze_ranks_and_lookups_match_jax(width):
    size, h = 1 << 14, 4
    hashes = rand_hashes((700, h), 3)
    valid = np.random.default_rng(4).random(700) < 0.8
    jst, pst = states(size, h)
    jst = jax_insert_bv(jst, jax_u64.from_numpy(hashes), jnp.asarray(valid))
    mibf_construct.insert_bv(pst, u64.from_numpy(hashes),
                             torch.from_numpy(valid))
    np.testing.assert_array_equal(pst.bv_words.numpy().view(np.uint32),
                                  np.asarray(jst.bv_words))
    jm, _ = jax_construct.get_empty_mibf(jst, width)
    m, counts = mibf_construct.get_empty_mibf(pst, width)
    assert m.d_size == jm.d_size and counts.shape == (jm.d_size,)
    np.testing.assert_array_equal(mibf.to_numpy(m)[1],
                                  np.asarray(jm.cum_ranks))
    # a random ID plane with saturation and strand bits
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1 << (8 * width), size=jm.d_size,
                        dtype=np.uint64).astype(NP_DTYPE[width])
    data[rng.random(jm.d_size) < 0.3] &= NP_DTYPE[width](15)
    jm = dataclasses.replace(jm, data=jnp.asarray(data))
    m = carry(jm)

    pos = rng.integers(0, size, size=5000, dtype=np.uint32)
    jr, jh = jax_mibf.rank_of_positions(jm, jnp.asarray(pos))
    r, hit = mibf.rank_of_positions(
        m, torch.from_numpy(pos.view(np.int32)))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))

    probe = np.concatenate([hashes[:200], rand_hashes((200, h), 6)])
    jr, jh, jraw = jax_mibf.at_rank_data(jm, jax_u64.from_numpy(probe),
                                         use_kernel=False)
    r, hit, raw = mibf.at_rank_data(m, u64.from_numpy(probe))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    for max_miss in (0, 1):
        jv, jok, jsat = jax_mibf.at(jm, jax_u64.from_numpy(probe), max_miss)
        v, ok, fsat = mibf.at(m, u64.from_numpy(probe), max_miss)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(fsat.numpy(), np.asarray(jsat))


def test_rank_lookup_matches_jax_kernels_in_interpret_mode():
    """The port's rank + ID lookup against rank_data_of_positions_kernel
    and rank_of_positions_kernel, whose Pallas gathers run in interpret
    mode (the smallest kernel-eligible bit vector, dense enough that the
    ID plane rides the windowed gather too)."""
    from btl_bloomfilter_tpu.kernels.scatter_or import WIN_WORDS

    rng = np.random.default_rng(7)
    size = WIN_WORDS * 32
    bv = rng.integers(0, 1 << 32, size=size // 32, dtype=np.uint32)
    jm = jax_mibf.freeze(jnp.asarray(bv), size, hash_num=4, kmer_size=21,
                         data_width=2)
    data = rng.integers(0, 1 << 16, size=jm.d_size, dtype=np.uint16)
    jm = dataclasses.replace(jm, data=jnp.asarray(data))
    m = carry(jm)
    hashes = rand_hashes((64, 128, 4), 8)

    pair, single = (jax_gather_words.gather_words_pair_sorted,
                    jax_gather_words.gather_words_sorted)
    try:
        jax_gather_words.gather_words_pair_sorted = functools.partial(
            pair, interpret=True)
        jax_gather_words.gather_words_sorted = functools.partial(
            single, interpret=True)
        jr, jh, jraw = jax_mibf.at_rank_data(
            jm, jax_u64.from_numpy(hashes), use_kernel=True)
        jr2, jh2 = jax_mibf.at_rank(jm, jax_u64.from_numpy(hashes),
                                    use_kernel=True)
    finally:
        jax_gather_words.gather_words_pair_sorted = pair
        jax_gather_words.gather_words_sorted = single
    r, hit, raw = mibf.at_rank_data(m, u64.from_numpy(hashes))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr2))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jh2))
    assert hit.any() and (~hit).any()


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("partial", [False, True])
def test_insert_mibf_matches_jax(width, partial):
    hashes, valid, ids, (jm, jc), (m, c) = built_pair(width,
                                                      partial=partial)
    # one sequence at a time
    jm1, jc1 = jm, jc
    m1, c1 = copy(m, c)
    for g in range(len(ids)):
        jm1, jc1 = jax_insert_mibf(jm1, jc1, jax_u64.from_numpy(hashes[g]),
                                   int(ids[g]), jnp.asarray(valid[g]))
        mibf_construct.insert_mibf(m1, c1, u64.from_numpy(hashes[g]),
                                   int(ids[g]), torch.from_numpy(valid[g]))
    assert_same(jm1, jc1, m1, c1)
    # the batch, equal to the sequence-at-a-time result
    jm2, jc2 = jax_insert_mibf_many(jm, jc, jax_u64.from_numpy(hashes),
                                    jnp.asarray(ids), jnp.asarray(valid))
    mibf_construct.insert_mibf_many(m, c, u64.from_numpy(hashes),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(valid))
    assert_same(jm2, jc2, m, c)
    assert_same(jm1, jc1, m, c)
    assert (mibf.to_numpy(m)[2] != 0).any()


@pytest.mark.parametrize("width", WIDTHS)
def test_insert_mibf_past_the_last_set_bit_matches_jax(width):
    """Values whose position misses the bit vector past its last set bit
    carry rank d_size: they count in no entry and write no ID."""
    size, h = 128, 2
    low = np.arange(20, dtype=np.uint64).reshape(10, h) * np.uint64(3)
    high = (np.uint64(size) * np.arange(1, 7, dtype=np.uint64)[:, None]
            + np.uint64(size - 1 - 2 * np.arange(h, dtype=np.uint64)))
    jst, pst = states(size, h)
    jst = jax_insert_bv(jst, jax_u64.from_numpy(low))
    mibf_construct.insert_bv(pst, u64.from_numpy(low))
    (jm, jc), (m, c) = (jax_construct.get_empty_mibf(jst, width),
                        mibf_construct.get_empty_mibf(pst, width))
    stream = np.concatenate([high, low[:4], high[:2]])
    jm, jc = jax_insert_mibf(jm, jc, jax_u64.from_numpy(stream), 5)
    mibf_construct.insert_mibf(m, c, u64.from_numpy(stream), 5)
    assert_same(jm, jc, m, c)
    assert int(mibf.rank_of_positions(
        m, torch.tensor([size - 1], dtype=torch.int32))[0]) == m.d_size


def phase3_pair(width, **kw):
    hashes, valid, ids, (jm, jc), (m, c) = built_pair(width, **kw)
    jm, jc = jax_insert_mibf_many(jm, jc, jax_u64.from_numpy(hashes),
                                  jnp.asarray(ids), jnp.asarray(valid))
    mibf_construct.insert_mibf_many(m, c, u64.from_numpy(hashes),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(valid))
    return hashes, valid, ids, (jm, jc), (m, c)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("max_entangled", [None, 2])
def test_insert_saturation_matches_jax(width, max_entangled):
    """Single-sequence phase 4 on a stream with duplicate and overlapping
    frames (entangled groups), an ID absent from phase 3 (mutate and
    saturate branches) and invalid frames; max_entangled=2 takes the
    whole-batch replay."""
    hashes, valid, ids, (jm, jc), (m, c) = phase3_pair(width)
    flat = hashes.reshape(-1, hashes.shape[-1])
    stream = np.concatenate([flat[40:80], flat[50:90], flat[40:60]])
    v = np.random.default_rng(7).random(len(stream)) < 0.9
    before = mibf.to_numpy(m)[2].copy()
    for idv in (3, 7):
        jm, jc = jax_insert_saturation(jm, jc, jax_u64.from_numpy(stream),
                                       idv, jnp.asarray(v),
                                       max_entangled=max_entangled)
        mibf_construct.insert_saturation(m, c, u64.from_numpy(stream), idv,
                                         torch.from_numpy(v),
                                         max_entangled=max_entangled)
        assert_same(jm, jc, m, c)
    assert (mibf.to_numpy(m)[2] != before).any()
    # two frames take the per-frame path
    mibf_construct.insert_saturation(m, c, u64.from_numpy(stream[:2]), 9)
    jm, jc = jax_insert_saturation(jm, jc, jax_u64.from_numpy(stream[:2]), 9)
    assert_same(jm, jc, m, c)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("max_entangled,partial", [
    (None, False), (8, False), (2, False), (None, True), (2, True)])
def test_insert_saturation_many_matches_jax(width, max_entangled, partial):
    hashes, valid, ids, (jm, jc), (m, c) = phase3_pair(width,
                                                       partial=partial)
    # two sequences under IDs absent from phase 3, so frames mutate and
    # saturate
    ids = ids.copy()
    ids[[1, 3]] += 10
    before = mibf.to_numpy(m)[2].copy()
    ms, cs = copy(m, c)
    jm, jc = jax_insert_saturation_many(
        jm, jc, jax_u64.from_numpy(hashes), jnp.asarray(ids),
        jnp.asarray(valid), max_entangled=max_entangled)
    mibf_construct.insert_saturation_many(
        m, c, u64.from_numpy(hashes), torch.from_numpy(ids),
        torch.from_numpy(valid), max_entangled=max_entangled)
    assert_same(jm, jc, m, c)
    assert (mibf.to_numpy(m)[2] != before).any()
    # equal to the frames one at a time in stream order
    for g in range(len(ids)):
        mibf_construct.insert_saturation_sequential(
            ms, cs, u64.from_numpy(hashes[g]), int(ids[g]),
            torch.from_numpy(valid[g]))
    assert_same(jm, jc, ms, cs)


# ---------------------------------------------------------------------------
# the whole 4-phase build
# ---------------------------------------------------------------------------

def random_refs(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    refs = []
    for _ in range(n):
        s = rng.choice(list("ACGT"), size=int(rng.integers(lo, hi)))
        s[rng.random(len(s)) < 0.01] = "N"
        refs.append("".join(s))
    # a shared stretch, so IDs compete for ranks
    refs[1] = refs[0][:150] + refs[1][150:]
    return refs


@pytest.mark.parametrize("n,k,h,width,batched", [
    (5, 15, 2, 1, True), (7, 21, 3, 2, True), (9, 17, 4, 4, True),
    (6, 19, 3, 2, False)])
def test_pipeline_build_matches_jax(n, k, h, width, batched):
    refs = random_refs(n, 300, 600, n + k)
    codes = [jax_tables.encode_seq(s) for s in refs]
    total = sum(len(s) for s in refs)
    jpipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=total, k=k, hash_num=h, occupancy=0.5))
    pipe = api.MIBFConstructPipeline(mibf_construct.create(
        expected_entries=total, k=k, hash_num=h, occupancy=0.5,
        device="cpu"))
    for c in codes:
        jpipe.insert_bv_seq(c)
        pipe.insert_bv_seq(c)
    jpipe.freeze(width)
    pipe.freeze(width)
    ids = list(range(1, n + 1))
    if batched:
        jpipe.insert_mibf_batch(codes, ids)
        pipe.insert_mibf_batch(codes, ids)
        jpipe.insert_saturation_batch(codes, ids)
        pipe.insert_saturation_batch(codes, ids)
    else:
        for c, i in zip(codes, ids):
            jpipe.insert_mibf_seq(c, i)
            pipe.insert_mibf_seq(c, i)
        for c, i in zip(codes, ids):
            jpipe.insert_saturation_seq(c, i)
            pipe.insert_saturation_seq(c, i)
    np.testing.assert_array_equal(mibf.to_numpy(pipe.m)[0],
                                  np.asarray(jpipe.m.bv_words))
    assert_same(jpipe.m, jpipe.counts, pipe.m, pipe.counts)
    data = mibf.to_numpy(pipe.m)[2]
    assert len(set(data.tolist()) & set(ids)) == n     # every ID stored
    assert mibf.get_pop_saturated(pipe.m) > 0


# ---------------------------------------------------------------------------
# statistics, saturate, set_data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
def test_stats_saturate_set_data_match_jax(width):
    hashes, valid, ids, (jm, jc), (m, c) = phase3_pair(width)
    probe = hashes[1, :12]
    jm = jax_mibf.saturate(jm, jax_u64.from_numpy(probe))
    mibf.saturate(m, u64.from_numpy(probe))
    assert_same(jm, jc, m, c)
    rng = np.random.default_rng(width)
    rank = rng.integers(0, jm.d_size + 5, size=40).astype(np.int32)
    rank[5:9] = rank[0]                    # duplicates: the last one wins
    vals = rng.integers(0, 40, size=40).astype(np.uint32)
    jm = jax_mibf.set_data(jm, jnp.asarray(rank), jnp.asarray(vals))
    mibf.set_data(m, torch.from_numpy(rank), torch.from_numpy(
        vals.astype(np.int64)))
    assert_same(jm, jc, m, c)

    assert mibf.get_pop(m) == jax_mibf.get_pop(jm)
    assert mibf.get_pop_non_zero(m) == int(jax_mibf.get_pop_non_zero(jm))
    assert mibf.get_pop_saturated(m) == int(jax_mibf.get_pop_saturated(jm))
    assert mibf.get_pop_saturated(m) > 0
    for num_ids in (4, 8, 64):
        jcounts, jsat = jax_mibf.get_id_counts(jm, num_ids)
        counts, sat = mibf.get_id_counts(m, num_ids)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        assert sat == int(jsat)
        for miss in (0, 1):
            jp, jprop = jax_mibf.calc_frame_probs(jm, num_ids, miss)
            p, prop = mibf.calc_frame_probs(m, num_ids, miss)
            np.testing.assert_allclose(p, jp, rtol=1e-12, atol=0)
            assert prop == pytest.approx(jprop, rel=1e-12)


def test_width8_and_huge_filters_raise():
    """Width 8 (an int64 ID plane) freezes, but its random-order insert on
    the device raises, as the reference's does; widths outside {1, 2, 4,
    8} and bit vectors past 2**32 bits raise (as the JAX package's do)."""
    words = torch.zeros(2, dtype=torch.int32)
    m8 = mibf.freeze(words, 64, 2, 5, data_width=8)
    assert m8.data.dtype == torch.int64 and m8.data_width == 8
    with pytest.raises(NotImplementedError):
        mibf_construct.insert_random_order_device(
            m8, torch.zeros(1, 2, dtype=torch.int64), 1, 1)
    with pytest.raises(ValueError):
        mibf.freeze(words, 64, 2, 5, data_width=3)
    m = mibf.freeze(words, 64, 2, 5)
    m.size = (1 << 32) + 64
    with pytest.raises(ValueError):
        mibf.positions(m, torch.zeros(3, dtype=torch.int64))


# ---------------------------------------------------------------------------
# .mibf / .sdsl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("seeds", [(), ("11011011101", "10111011011")])
def test_store_load_match_jax(tmp_path, width, seeds):
    _, _, _, (jm, _), _ = phase3_pair(width)
    jm = jax_mibf.saturate(jm, jax_u64.from_numpy(rand_hashes((3, 3), 1)))
    jm = dataclasses.replace(jm, sseeds=seeds)
    jpath, path = str(tmp_path / "j.mibf"), str(tmp_path / "p.mibf")
    jax_mibf_format.store_mibf(jm, jpath)
    m = carry(jm)
    mibf_format.store_mibf(m, path)
    for ext in ("", ".sdsl"):
        with open(jpath + ext, "rb") as f, open(path + ext, "rb") as g:
            assert f.read() == g.read()
    back = mibf_format.load_mibf(jpath, data_width=width, device="cpu")
    assert (back.size, back.hash_num, back.kmer_size, back.d_size,
            back.data_width, back.sseeds) == (jm.size, jm.hash_num,
                                             jm.kmer_size, jm.d_size, width,
                                             seeds)
    for got, ref in zip(mibf.to_numpy(back), (jm.bv_words, jm.cum_ranks,
                                             jm.data)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    jback = jax_mibf_format.load_mibf(path, data_width=width)
    np.testing.assert_array_equal(np.asarray(jback.data),
                                  np.asarray(jm.data))
    raw = open(path, "rb").read()
    assert struct.unpack_from("<8sIQIII", raw, 0)[:2] == (
        b"MIBLOOMF", 32 + jm.kmer_size * len(seeds))


def test_load_rejects_a_wrong_header(tmp_path):
    _, _, _, (jm, _), _ = phase3_pair(2)
    path = str(tmp_path / "f.mibf")
    jax_mibf_format.store_mibf(jm, path)
    raw = bytearray(open(path, "rb").read())
    bad = str(tmp_path / "bad.mibf")
    for patch, match in ((lambda b: b.__setitem__(0, ord("X")), "type"),
                         (lambda b: struct.pack_into("<I", b, 28, 2),
                          "version"),
                         (lambda b: struct.pack_into("<Q", b, 12,
                                                     jm.d_size + 1), "size")):
        b = bytearray(raw)
        patch(b)
        open(bad, "wb").write(bytes(b))
        open(bad + ".sdsl", "wb").write(open(path + ".sdsl", "rb").read())
        with pytest.raises(ValueError, match=match):
            mibf_format.load_mibf(bad, device="cpu")


def test_sdsl_round_trip_and_validation():
    rng = np.random.default_rng(4)
    size_bits = 5000  # multiple superblocks + a partial one
    bits = rng.integers(0, 1 << 32, size=(size_bits + 31) // 32,
                        dtype=np.uint32)
    buf = sdsl.serialize_bit_vector_il(bits, size_bits)
    back, sz = sdsl.deserialize_bit_vector_il(buf)
    assert sz == size_bits
    mask_last = (1 << (size_bits % 32)) - 1
    expect, got = bits.copy(), back.copy()
    expect[-1] &= mask_last
    got[-1] &= mask_last
    np.testing.assert_array_equal(got, expect)
    assert buf == sdsl.serialize_bit_vector_il(bits, size_bits)
    bad = bytearray(buf)
    bad[-4] ^= 0xFF
    with pytest.raises(ValueError):
        sdsl.deserialize_bit_vector_il(bytes(bad))


def sdsl_variant(buf, trailing=False, sample_pad=0):
    """An .sdsl buffer in one of the convention variants the loader
    tolerates: an optional trailing total-rank word after the interleaved
    blocks, and a zero-padded (or, sample_pad < 0, truncated) rank-sample
    vector."""
    size_bits = struct.unpack_from("<Q", buf, 0)[0]
    nwords = struct.unpack_from("<Q", buf, 8)[0] // 64
    il = np.frombuffer(buf, dtype="<u8", count=nwords, offset=16)
    off = 16 + nwords * 8
    nsamples = struct.unpack_from("<Q", buf, off)[0] // 64
    samples = np.frombuffer(buf, dtype="<u8", count=nsamples, offset=off + 8)
    blocks = il.reshape(-1, 9)
    if trailing:
        total = int(blocks[-1, 0]) + int(
            np.unpackbits(blocks[-1, 1:].astype("<u8").view(np.uint8)).sum())
        il = np.concatenate([il, np.asarray([total], dtype="<u8")])
    if sample_pad > 0:
        samples = np.concatenate([samples,
                                  np.zeros(sample_pad, dtype="<u8")])
    elif sample_pad < 0:
        samples = samples[:sample_pad]
    return (struct.pack("<Q", size_bits) + struct.pack("<Q", 64 * len(il))
            + il.tobytes() + struct.pack("<Q", 64 * len(samples))
            + samples.tobytes())


@pytest.mark.parametrize("trailing,sample_pad,convention", [
    (False, 0, "bfs-tree"),
    (True, 0, "bfs-tree"),
    (False, 3, "zero-padded"),
    (True, -1, "truncated"),
])
def test_sdsl_loader_convention_tolerance(trailing, sample_pad, convention):
    rng = np.random.default_rng(9)
    size_bits = 4096
    bits = rng.integers(0, 1 << 32, size=size_bits // 32, dtype=np.uint32)
    base = sdsl.serialize_bit_vector_il(bits, size_bits)
    back, sz, info = sdsl.deserialize_bit_vector_il(
        sdsl_variant(base, trailing, sample_pad), with_info=True)
    assert sz == size_bits
    np.testing.assert_array_equal(back, bits)
    assert info == {"trailing_total_rank": trailing,
                    "sample_convention": convention}
    # a wrong trailing word is still rejected
    bad = bytearray(sdsl_variant(base, trailing=True))
    toff = 16 + (struct.unpack_from("<Q", bad, 8)[0] // 64 - 1) * 8
    struct.pack_into("<Q", bad, toff, struct.unpack_from("<Q", bad, toff)[0]
                     + 1)
    with pytest.raises(ValueError):
        sdsl.deserialize_bit_vector_il(bytes(bad))


def test_sdsl_loader_rejects_cut_short_sample_tree():
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 1 << 32, size=8192 // 32, dtype=np.uint32)
    base = sdsl.serialize_bit_vector_il(bits, 8192)
    with pytest.raises(ValueError, match="truncated or corrupt"):
        sdsl.deserialize_bit_vector_il(sdsl_variant(base, sample_pad=-2))
