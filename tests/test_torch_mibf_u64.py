"""The port's width-8 MIBF (MIBloomFilter<uint64_t>, uint64 IDs, s_mask and
s_strand at bits 63 and 62) against the JAX package, case for case the
cases of tests/test_mibf_u64.py, plus the batched phase 4 against the JAX
sequential mirror (the only phase 4 the JAX package runs at width 8) on
frames that repeat ranks, IDs and saturated entries, phase 3 for many
sequences against a loop of single-ID JAX calls, the construct pipeline at
width 8, the statistics and the 64-bit reservoir modulo against Python
ints.

Every ID that matters needs the high plane (BIG_ID > 2**32). Inputs are
made with numpy from fixed seeds and handed to both sides; the port's
int64 ID plane is compared with the JAX package's two uint32 planes
(``mibf.to_numpy``). Everything compared is integers, bools or bytes, so
the tolerance is zero, except ``calc_frame_probs[_strand]``, held within
1e-12 relative (the same double-precision arithmetic on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.io import mibf_format as jax_mibf_format
from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.models import mibf_query as jax_query
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch import api
from btl_bloomfilter_tpu_torch.io import mibf_format
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct, mibf_query
from btl_bloomfilter_tpu_torch.ops import u64

from test_mibf import PyMIBF, rand_hashes

torch.set_num_threads(1)

BIG_ID = (37 << 40) | 12345            # an ID that needs the high plane
SAT = 1 << 63
STRAND = 1 << 62

# jitted JAX references (eager JAX is slow on the CPU); the width-8 ID is a
# Python int inside the JAX reservoir and phase-4 step, so it is static
jax_insert_mibf = jax.jit(jax_construct.insert_mibf,
                          static_argnames=("id_value",))
jax_insert_sat_seq = jax.jit(jax_construct.insert_saturation_sequential,
                             static_argnames=("id_value",))


def states(size, h):
    """(JAX, port) empty phase-1 states of ``size`` bits."""
    return (jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=11, hash_num=h, occupancy=0.5, sseeds=()),
        mibf_construct.BitVectorState(
            bv_words=torch.zeros(size // 32, dtype=torch.int32),
            filter_size=size, kmer_size=11, hash_num=h, occupancy=0.5,
            sseeds=()))


def build_pair64(size=4096, h=4, n=200, seed=1):
    """Phase 1 of ``n`` random frames on both sides, frozen at width 8:
    (hashes, (jax m, counts), (port m, counts))."""
    hashes = rand_hashes(n, h, seed)
    jst, pst = states(size, h)
    jst = jax_construct.insert_bv(jst, jax_u64.from_numpy(hashes))
    mibf_construct.insert_bv(pst, u64.from_numpy(hashes))
    np.testing.assert_array_equal(pst.bv_words.numpy().view(np.uint32),
                                  np.asarray(jst.bv_words))
    return (hashes, jax_construct.get_empty_mibf(jst, data_width=8),
            mibf_construct.get_empty_mibf(pst, data_width=8))


def jax_u64_values(m):
    planes = np.asarray(m.data)
    return (planes[0].astype(np.uint64)
            | (planes[1].astype(np.uint64) << np.uint64(32)))


def pair_values(x):
    """A JAX U64 pair as numpy uint64."""
    return (np.asarray(x.lo).astype(np.uint64)
            | (np.asarray(x.hi).astype(np.uint64) << np.uint64(32)))


def assert_same(jm, jcounts, m, counts):
    """The port's ID plane and counts equal the JAX planes and counts."""
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    np.testing.assert_array_equal(counts.numpy().view(np.uint32),
                                  np.asarray(jcounts))


def test_freeze_width8_shapes():
    _, (jm, jcounts), (m, counts) = build_pair64()
    assert m.data_width == 8 and m.d_size == jm.d_size
    assert m.data.dtype == torch.int64 and m.data.shape == (jm.d_size,)
    # counters are uint32, as the reference's (they wrap at 2**32)
    assert counts.dtype == torch.int32 and counts.shape == (jm.d_size,)
    bv, cum, planes = mibf.to_numpy(m)
    assert planes.shape == (2, jm.d_size) and planes.dtype == np.uint32
    np.testing.assert_array_equal(cum, np.asarray(jm.cum_ranks))
    assert_same(jm, jcounts, m, counts)
    assert (m.s_mask, m.s_strand, m.s_anti_mask, m.s_id_mask) == (
        jm.s_mask, jm.s_strand, jm.s_anti_mask, jm.s_id_mask)


def test_insert_mibf_width8_matches_jax():
    _, (jm, jcounts), (m, counts) = build_pair64()
    py = PyMIBF(4096, 4, width_bits=64)
    py.insert_bv(rand_hashes(200, 4, 1))
    py.freeze()
    for idv, seed in [(3, 11), (BIG_ID, 12), (9, 13)]:
        m_hashes = rand_hashes(200, 4, 1)[seed % 100: seed % 100 + 40]
        jm, jcounts = jax_insert_mibf(jm, jcounts,
                                      jax_u64.from_numpy(m_hashes), idv)
        mibf_construct.insert_mibf(m, counts, u64.from_numpy(m_hashes), idv)
        py.insert_mibf(m_hashes, idv)
        assert_same(jm, jcounts, m, counts)
    np.testing.assert_array_equal(mibf.ids_numpy(m),
                                  py.data.astype(np.uint64))
    assert (mibf.ids_numpy(m) == np.uint64(BIG_ID)).any()


def test_insert_saturation_width8_matches_jax():
    _, (jm, jcounts), (m, counts) = build_pair64()
    base = rand_hashes(200, 4, 1)
    ids = [(3, 0), (BIG_ID, 40), (9, 80)]
    for idv, lo in ids:
        jm, jcounts = jax_insert_mibf(
            jm, jcounts, jax_u64.from_numpy(base[lo: lo + 40]), idv)
        mibf_construct.insert_mibf(m, counts, u64.from_numpy(
            base[lo: lo + 40]), idv)
    for idv, lo in ids + [(7, 100)]:
        # the JAX package's width-8 phase 4 is its sequential mirror; the
        # port's is the batched one
        jm, jcounts = jax_insert_sat_seq(
            jm, jcounts, jax_u64.from_numpy(base[lo: lo + 40]), idv)
        mibf_construct.insert_saturation(m, counts, u64.from_numpy(
            base[lo: lo + 40]), idv)
        assert_same(jm, jcounts, m, counts)
    assert mibf.get_pop_saturated(m) > 0


@pytest.mark.parametrize("max_entangled", [None, 2])
def test_batched_phase4_width8_matches_sequential(max_entangled):
    """Heavy rank sharing (a 512-bit vector), frames repeated inside and
    across sequences, IDs that are already present, saturated entries and
    invalid frames: the batched phase 4 (one ID, and one ID a sequence)
    equals the JAX sequential mirror frame by frame."""
    rng = np.random.default_rng(5)
    G, W, h = 4, 40, 3
    hashes = rand_hashes(G * W, h, 7).reshape(G, W, h)
    hashes[1, :10] = hashes[0, :10]          # repeated across sequences
    hashes[2, 5:9] = hashes[2, 1]            # repeated inside one
    valid = rng.random((G, W)) < 0.9
    ids = [BIG_ID, 5, BIG_ID + 1, 2]
    jst, pst = states(512, h)
    jst = jax_construct.insert_bv(jst, jax_u64.from_numpy(
        hashes.reshape(-1, h)))
    mibf_construct.insert_bv(pst, u64.from_numpy(hashes.reshape(-1, h)))
    jm, jcounts = jax_construct.get_empty_mibf(jst, data_width=8)
    m, counts = mibf_construct.get_empty_mibf(pst, data_width=8)
    for g in (0, 2):
        jm, jcounts = jax_insert_mibf(jm, jcounts,
                                      jax_u64.from_numpy(hashes[g]), ids[g])
        mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes[g]),
                                   ids[g])
    jm = jax_mibf.saturate(jm, jax_u64.from_numpy(hashes[3, :6]))
    mibf.saturate(m, u64.from_numpy(hashes[3, :6]))
    assert_same(jm, jcounts, m, counts)
    assert mibf.get_pop_saturated(m) > 0
    m1 = dataclasses.replace(m, data=m.data.clone())
    counts1 = counts.clone()
    for g in range(G):
        jm, jcounts = jax_insert_sat_seq(
            jm, jcounts, jax_u64.from_numpy(hashes[g]), ids[g],
            jnp.asarray(valid[g]))
        mibf_construct.insert_saturation(
            m, counts, u64.from_numpy(hashes[g]), ids[g],
            torch.from_numpy(valid[g]), max_entangled=max_entangled)
        assert_same(jm, jcounts, m, counts)
    # all sequences in one batch: equal to them one at a time
    mibf_construct.insert_saturation_many(
        m1, counts1, u64.from_numpy(hashes), ids, torch.from_numpy(valid),
        max_entangled=max_entangled)
    assert_same(jm, jcounts, m1, counts1)


def test_insert_mibf_many_width8_matches_single_id_calls():
    """Phase 3 for many sequences at width 8 (the JAX package takes one ID
    a call there) equals a loop of JAX insert_mibf calls, one ID each."""
    rng = np.random.default_rng(8)
    G, W, h = 4, 50, 3
    hashes = rand_hashes(G * W, h, 9).reshape(G, W, h)
    hashes[3, :12] = hashes[1, :12]
    valid = rng.random((G, W)) < 0.85
    ids = [BIG_ID, 6, BIG_ID ^ (1 << 33), 11]
    jst, pst = states(1024, h)
    jst = jax_construct.insert_bv(jst, jax_u64.from_numpy(
        hashes.reshape(-1, h)))
    mibf_construct.insert_bv(pst, u64.from_numpy(hashes.reshape(-1, h)))
    jm, jcounts = jax_construct.get_empty_mibf(jst, data_width=8)
    m, counts = mibf_construct.get_empty_mibf(pst, data_width=8)
    for g in range(G):
        jm, jcounts = jax_insert_mibf(jm, jcounts,
                                      jax_u64.from_numpy(hashes[g]), ids[g],
                                      jnp.asarray(valid[g]))
    mibf_construct.insert_mibf_many(m, counts, u64.from_numpy(hashes), ids,
                                    torch.from_numpy(valid))
    assert_same(jm, jcounts, m, counts)


def test_at_and_saturate_width8():
    hashes, (jm, jcounts), (m, counts) = build_pair64(n=50)
    jm, jcounts = jax_insert_mibf(jm, jcounts, jax_u64.from_numpy(hashes),
                                  BIG_ID)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), BIG_ID)
    hs = u64.from_numpy(hashes)
    jvals, jok, jsat = jax_mibf.at(jm, jax_u64.from_numpy(hashes))
    vals, ok, fsat = mibf.at(m, hs)
    np.testing.assert_array_equal(u64.to_numpy(vals), pair_values(jvals))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(fsat.numpy(), np.asarray(jsat))
    assert ok.all() and not fsat.any()
    assert (u64.to_numpy(vals) == np.uint64(BIG_ID)).any()

    jm2 = jax_mibf.saturate(jm, jax_u64.from_numpy(hashes[:5]))
    mibf.saturate(m, hs[:5])
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm2.data))
    jvals2, _, jsat2 = jax_mibf.at(jm2, jax_u64.from_numpy(hashes[:5]))
    vals2, _, fsat2 = mibf.at(m, hs[:5])
    assert fsat2.all()
    np.testing.assert_array_equal(fsat2.numpy(), np.asarray(jsat2))
    # values come back with the saturation bit stripped
    np.testing.assert_array_equal(u64.to_numpy(vals2), pair_values(jvals2))
    np.testing.assert_array_equal(u64.to_numpy(vals2),
                                  u64.to_numpy(vals)[:5])
    assert mibf.get_pop_saturated(m) == int(jax_mibf.get_pop_saturated(jm2))
    assert mibf.get_pop_saturated(m) > 0
    assert int(jax_mibf.get_pop_saturated(jm)) == 0


def test_at_rank_data_width8():
    hashes, (jm, jcounts), (m, counts) = build_pair64(n=40)
    jm, jcounts = jax_insert_mibf(jm, jcounts, jax_u64.from_numpy(hashes),
                                  BIG_ID)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), BIG_ID)
    # misses too: half the frames were never inserted
    probe = np.concatenate([hashes, rand_hashes(40, 4, 77)])
    jrank, jhit, jraw = jax_mibf.at_rank_data(jm, jax_u64.from_numpy(probe))
    rank, hit, raw = mibf.at_rank_data(m, u64.from_numpy(probe))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(u64.to_numpy(raw), pair_values(jraw))
    assert hit[:40].all() and not hit.all()
    np.testing.assert_array_equal(
        u64.to_numpy(raw)[:40], mibf.ids_numpy(m)[rank[:40].numpy()])


def test_set_data_width8():
    """set_data writes the ID and keeps only the saturation bit of the
    entry it overwrites, not its strand bit."""
    hashes, (jm, _), (m, _) = build_pair64(n=30)
    rank, _ = mibf.at_rank(m, u64.from_numpy(hashes[:6]))
    rk = rank.reshape(-1)
    # strand-carrying entries first, then saturate half of them
    ids = np.full(rk.shape, BIG_ID | STRAND, np.uint64)
    jm = jax_mibf.set_data(jm, jnp.asarray(rk.numpy()),
                           jax_u64.from_numpy(ids))
    mibf.set_data(m, rk, u64.from_numpy(ids))
    jm = jax_mibf.saturate(jm, jax_u64.from_numpy(hashes[:3]))
    mibf.saturate(m, u64.from_numpy(hashes[:3]))
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    new = np.full(rk.shape, BIG_ID, np.uint64)
    jm = jax_mibf.set_data(jm, jnp.asarray(rk.numpy()),
                           jax_u64.from_numpy(new))
    mibf.set_data(m, rk, u64.from_numpy(new))
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    vals = mibf.ids_numpy(m)[rk.numpy()]
    sat_rk = mibf.at_rank(m, u64.from_numpy(hashes[:3]))[0].reshape(-1)
    assert (mibf.ids_numpy(m)[sat_rk.numpy()] == np.uint64(BIG_ID | SAT)
            ).all()
    assert set(vals.tolist()) <= {BIG_ID, BIG_ID | SAT}


def test_id_counts_width8():
    hashes, (jm, jcounts), (m, counts) = build_pair64(n=60, h=3, seed=9)
    jm, jcounts = jax_insert_mibf(jm, jcounts, jax_u64.from_numpy(hashes), 2)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), 2)
    cts, sat = mibf.get_id_counts(m, 8)
    jcts, jsat = jax_mibf.get_id_counts(jm, 8)
    np.testing.assert_array_equal(cts.numpy(), np.asarray(jcts))
    assert sat == int(jsat) == 0
    assert int(cts[2]) > 0 and int(cts[0]) == m.d_size - int(cts[2])
    # a big ID lands outside the [0, num_ids) table (dropped)
    jm, jcounts = jax_insert_mibf(jm, jcounts, jax_u64.from_numpy(hashes),
                                  BIG_ID)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), BIG_ID)
    # odd entries: strand bits on small IDs, a saturated small ID, and an
    # entry of exactly s_mask (not saturated: value > s_mask is the test)
    rk = torch.arange(6)
    odd = np.array([3 | STRAND, 5 | STRAND | SAT, 4 | SAT, SAT, 6, STRAND],
                   np.uint64)
    jm = jax_mibf.set_data(jm, jnp.asarray(rk.numpy()),
                           jax_u64.from_numpy(odd))
    mibf.set_data(m, rk, u64.from_numpy(odd))
    for fn, jfn in ((mibf.get_id_counts, jax_mibf.get_id_counts),
                    (mibf.get_id_counts_strand,
                     jax_mibf.get_id_counts_strand)):
        cts, sat = fn(m, 8)
        jcts, jsat = jfn(jm, 8)
        np.testing.assert_array_equal(cts.numpy(), np.asarray(jcts))
        assert sat == int(jsat)
    assert int(cts[:8].sum()) <= m.d_size
    assert mibf.get_pop_non_zero(m) == int(jax_mibf.get_pop_non_zero(jm))
    assert mibf.get_pop_saturated(m) == int(jax_mibf.get_pop_saturated(jm))
    for fn, jfn in ((mibf.calc_frame_probs, jax_mibf.calc_frame_probs),
                    (mibf.calc_frame_probs_strand,
                     jax_mibf.calc_frame_probs_strand)):
        probs, satp = fn(m, 8, 1)
        jprobs, jsatp = jfn(jm, 8, 1)
        np.testing.assert_allclose(probs, jprobs, rtol=1e-12)
        assert satp == pytest.approx(jsatp, rel=1e-12)


def test_mibf_store_load_roundtrip_width8(tmp_path):
    hashes, (jm, jcounts), (m, counts) = build_pair64(n=80, h=3, seed=5)
    jm, jcounts = jax_insert_mibf(jm, jcounts, jax_u64.from_numpy(hashes),
                                  BIG_ID)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), BIG_ID)
    jm = jax_mibf.saturate(jm, jax_u64.from_numpy(hashes[:4]))
    mibf.saturate(m, u64.from_numpy(hashes[:4]))
    jp, p = str(tmp_path / "j8.mibf"), str(tmp_path / "f8.mibf")
    jax_mibf_format.store_mibf(jm, jp)
    mibf_format.store_mibf(m, p)
    for ext in ("", ".sdsl"):
        assert open(jp + ext, "rb").read() == open(p + ext, "rb").read()
    m2 = mibf_format.load_mibf(jp, data_width=8, device="cpu")
    assert (m2.size, m2.hash_num, m2.kmer_size, m2.d_size) == \
           (m.size, m.hash_num, m.kmer_size, m.d_size)
    assert torch.equal(m2.data, m.data)
    # byte-stable restore
    p2 = str(tmp_path / "g8.mibf")
    mibf_format.store_mibf(m2, p2)
    assert open(p, "rb").read() == open(p2, "rb").read()
    # the raw byte stream is the little-endian uint64 value stream
    body = open(p, "rb").read()[32:]
    np.testing.assert_array_equal(np.frombuffer(body, dtype="<u8"),
                                  jax_u64_values(jm))


@pytest.mark.parametrize("use_strand", [False, True])
def test_insert_random_order_width8_host(use_strand):
    hashes, (jm, _), (m, _) = build_pair64(n=30, h=3)
    strand = (np.random.default_rng(3).random((30, 3)) < 0.5
              if use_strand else None)
    jm, jsucc = jax_construct.insert_random_order(jm, hashes[:30], BIG_ID, 1,
                                                  strand=strand)
    m, succ = mibf_construct.insert_random_order(m, hashes[:30], BIG_ID, 1,
                                                 strand=strand)
    np.testing.assert_array_equal(succ, jsucc)
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    assert succ.all()
    got = mibf.ids_numpy(m)[mibf.at_rank(m, u64.from_numpy(
        hashes[:30]))[0].numpy()] & np.uint64(~STRAND & (2**64 - 1))
    assert (got == np.uint64(BIG_ID)).any(axis=-1).all()


def test_insert_random_order_device_width8_raises():
    hashes, (jm, _), (m, _) = build_pair64(n=4, h=3)
    with pytest.raises(NotImplementedError):
        jax_construct.insert_random_order_device(
            jm, jax_u64.from_numpy(hashes[:4]), 1, 1)
    with pytest.raises(NotImplementedError, match="host mirror"):
        mibf_construct.insert_random_order_device(
            m, u64.from_numpy(hashes[:4]), 1, 1)


def test_width8_classification_raises():
    """The JAX engine has no width-8 path (it fails converting the uint64
    masks to uint32); the port says so with NotImplementedError."""
    hashes, (jm, jcounts), (m, counts) = build_pair64(n=20)
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), BIG_ID)
    jqs = jax_query.MIBFQuerySupport(
        m=jm, per_frame_prob=[0.0, 0.1], extra_count=2.0,
        extra_frame_limit=10**6, max_miss=0, min_count=1,
        best_hit_agree=False)
    with pytest.raises(OverflowError):
        jqs.query(jax_u64.from_numpy(hashes), np.ones(20, bool),
                  np.ones(2, np.int32))
    qs = mibf_query.MIBFQuerySupport(
        m=m, per_frame_prob=[0.0, 0.1], extra_count=2.0,
        extra_frame_limit=10**6, max_miss=0, min_count=1,
        best_hit_agree=False)
    hs, v = u64.from_numpy(hashes), torch.ones(20, dtype=torch.bool)
    mc = torch.ones(2, dtype=torch.int32)
    for call in (lambda: qs.query(hs, v, mc),
                 lambda: qs.query_paired(hs, v, hs, v, mc),
                 lambda: qs.get_match_signature(hs, v),
                 lambda: mibf_query.query_scan(
                     m, torch.zeros(20, 4, dtype=torch.int64),
                     torch.ones(20, 4, dtype=torch.bool), v,
                     torch.zeros(20, dtype=torch.int32), mc, 2, 10**6)):
        with pytest.raises(NotImplementedError, match="width-8"):
            call()


def test_construct_pipeline_width8():
    """api.MIBFConstructPipeline at width 8, per sequence and per batch,
    equals the JAX model functions on the same frames (the JAX pipeline's
    jitted calls trace the ID and cannot take width 8)."""
    rng = np.random.default_rng(12)
    refs = [rng.integers(0, 4, size=n, dtype=np.uint8)
            for n in (150, 220, 90)]
    refs[1][40:190] = refs[0]               # shared k-mers across IDs
    ids = [BIG_ID, 3, BIG_ID + 7]
    st = mibf_construct.create(500, 11, 4, 0.5, device="cpu")
    pipe = api.MIBFConstructPipeline(st)
    frames = [pipe.hash.frames(c) for c in refs]
    for c in refs:
        pipe.insert_bv_seq(c)
    words0 = pipe.state.bv_words.clone()
    pipe.freeze(8)
    for c, i in zip(refs, ids):
        pipe.insert_mibf_seq(c, i)
    for c, i in zip(refs, ids):
        pipe.insert_saturation_seq(c, i)
    jst = jax_construct.create(500, 11, 4, 0.5)
    jfr = [(jax_u64.from_numpy(u64.to_numpy(f.hashes)),
            jnp.asarray(f.valid.numpy())) for f in frames]
    for hs, v in jfr:
        jst = jax_construct.insert_bv(jst, hs, v)
    np.testing.assert_array_equal(words0.numpy().view(np.uint32),
                                  np.asarray(jst.bv_words))
    jm, jcounts = jax_construct.get_empty_mibf(jst, data_width=8)
    for (hs, v), i in zip(jfr, ids):
        jm, jcounts = jax_insert_mibf(jm, jcounts, hs, i, v)
    for (hs, v), i in zip(jfr, ids):
        jm, jcounts = jax_insert_sat_seq(jm, jcounts, hs, i, v)
    assert_same(jm, jcounts, pipe.m, pipe.counts)
    # the batch calls: the same filter
    pipe2 = api.MIBFConstructPipeline(dataclasses.replace(
        st, bv_words=words0.clone()))
    pipe2.freeze(8)
    pipe2.insert_mibf_batch(refs, ids)
    pipe2.insert_saturation_batch(refs, ids)
    assert_same(jm, jcounts, pipe2.m, pipe2.counts)


def test_mod_u32_random():
    """The 64-bit reservoir modulo against Python ints, divisors up to
    2**32 - 1 (the counters' range)."""
    rng = np.random.default_rng(77)
    v = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    c = rng.integers(1, 1 << 32, size=4096, dtype=np.uint64)
    c[:4] = [1, 2, (1 << 31) + 1, (1 << 32) - 1]
    v[:2] = [2**64 - 1, 1 << 63]
    got = u64.mod_u32(u64.from_numpy(v), torch.from_numpy(c.view(np.int64)))
    want = np.array([int(a) % int(b) for a, b in zip(v, c)], np.uint64)
    np.testing.assert_array_equal(u64.to_numpy(got), want)
    # and the JAX helper agrees where it is defined (divisors below 2**31)
    c31 = (c % np.uint64(1 << 31)) | np.uint64(1)
    jgot = np.asarray(jax_u64.mod_u32(jax_u64.from_numpy(v),
                                      jnp.asarray(c31.astype(np.uint32))))
    np.testing.assert_array_equal(
        u64.to_numpy(u64.mod_u32(u64.from_numpy(v),
                                 torch.from_numpy(c31.view(np.int64)))),
        jgot.astype(np.uint64))
