"""The port's MIBloomFilter::insert (the random-order, strand-carrying
insert) and the strand statistics against the JAX package.

``mibf_construct.insert_random_order`` (the host mirror) and
``insert_random_order_device`` (on the CPU, the plain version of the
``mibf_random_insert`` kernel) against the JAX ``insert_random_order`` at ID
widths 1, 2 and 4, and against the JAX ``insert_random_order_device`` at
width 2, on the cases of tests/test_mibf.py: max_count 1-3, with and
without strand, duplicate frames, h = 3-5, pre-set and pre-saturated
entries, the dense and the collision-free filter; a frame mask; the
kernel's plain version on its own. ``get_id_counts_strand`` and
``calc_frame_probs_strand`` (whole-table normalisation) on a filter with
strand-carrying and saturated entries; the strand-carrying classification
of tests/test_mibf_query.py. Integers and bools compare exactly; the frame
probabilities to 1e-12 relative (the same float64 formula on both sides).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.models import mibf_query as jax_query
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.kernels import mibf_random_insert
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct, mibf_query
from btl_bloomfilter_tpu_torch.ops import u64

torch.set_num_threads(1)

CASES = [  # max_count, strand, duplicate frames, h, size
    (1, False, False, 4, 4096),   # dense: the saturation fallback
    (1, True, False, 3, 4096),    # strand + fallback (legal at max == 1)
    (2, False, True, 4, 4096),    # dense collisions, no strand
    (3, False, True, 5, 4096),
    # strand with max > 1 needs a collision-free filter: a cross-frame
    # position collision with opposite strand values reaches the
    # reference's count == 0 assert (MIBloomFilter.hpp:431)
    (2, True, True, 4, 1 << 20),
    (3, True, True, 5, 1 << 20),
]


def case_inputs(maxc, use_strand, dup, h, size, width):
    """The JAX test's frames and filter: a JAX-built bit vector, and at
    max_count 1 pre-set and pre-saturated entries."""
    rng = np.random.default_rng(42 + maxc)
    hashes = rng.integers(0, 1 << 64, size=(40, h), dtype=np.uint64)
    # strand is a function of the k-mer: duplicate frames repeat it
    strand = rng.random(hashes.shape) < 0.5 if use_strand else None
    if dup:
        idx = rng.integers(0, 40, size=80)
        hashes = hashes[idx]
        if strand is not None:
            strand = strand[idx]
    st = jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=5, hash_num=h, occupancy=0.5, sseeds=())
    st = jax_construct.insert_bv(st, jax_u64.from_numpy(hashes))
    jm, _ = jax_construct.get_empty_mibf(st, data_width=width)
    d0 = np.asarray(jm.data).copy()
    if maxc == 1:
        d0[rng.integers(0, len(d0), size=len(d0) // 3)] = 5
        d0[rng.integers(0, len(d0), size=len(d0) // 7)] = jm.s_mask | 5
    return dataclasses.replace(jm, data=jnp.asarray(d0)), hashes, strand


def port_copy(jm):
    return mibf.from_numpy(np.asarray(jm.bv_words), np.asarray(jm.data),
                           size=jm.size, hash_num=jm.hash_num,
                           kmer_size=jm.kmer_size, data_width=jm.data_width,
                           device="cpu")


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("maxc,use_strand,dup,h,size", CASES)
def test_random_order_insert_matches_jax(maxc, use_strand, dup, h, size,
                                         width):
    jm, hashes, strand = case_inputs(maxc, use_strand, dup, h, size, width)
    ja, sa = jax_construct.insert_random_order(jm, hashes, 5, maxc,
                                               strand=strand)
    expect = np.asarray(ja.data)
    m = port_copy(jm)
    _, s1 = mibf_construct.insert_random_order(m, hashes, 5, maxc,
                                               strand=strand)
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], expect)
    np.testing.assert_array_equal(s1, np.asarray(sa))
    m = port_copy(jm)
    _, s2 = mibf_construct.insert_random_order_device(
        m, u64.from_numpy(hashes), 5, maxc,
        strand=None if strand is None else torch.from_numpy(strand))
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], expect)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(sa))
    if maxc == 1:
        assert (expect != np.asarray(jm.data)).any()
    if width == 2:
        jb, sb = jax_construct.insert_random_order_device(
            jm, jax_u64.from_numpy(hashes), 5, maxc,
            strand=None if strand is None else jnp.asarray(strand))
        np.testing.assert_array_equal(np.asarray(jb.data), expect)
        np.testing.assert_array_equal(np.asarray(sb), np.asarray(sa))


def test_random_order_insert_device_with_valid_matches_jax():
    """Masked frames write nothing and fail; frames shaped [2, 20, h]."""
    jm, hashes, strand = case_inputs(1, True, False, 3, 4096, 2)
    valid = np.random.default_rng(1).random(40) < 0.7
    jb, sb = jax_construct.insert_random_order_device(
        jm, jax_u64.from_numpy(hashes), 7, 1, strand=jnp.asarray(strand),
        valid=jnp.asarray(valid))
    m = port_copy(jm)
    _, s = mibf_construct.insert_random_order_device(
        m, u64.from_numpy(hashes).reshape(2, 20, 3), 7, 1,
        strand=torch.from_numpy(strand).reshape(2, 20, 3),
        valid=torch.from_numpy(valid).reshape(2, 20))
    assert s.shape == (2, 20)
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jb.data))
    np.testing.assert_array_equal(s.reshape(-1).numpy(), np.asarray(sb))
    assert not s.reshape(-1)[~torch.from_numpy(valid)].any()


def test_random_insert_plain_checks_and_strand_bits():
    """The kernel's plain version directly: values carry the strand bit
    where a slot's strand differs from the direction (max_count odd: the
    forward strand, False, differs), IDs are cut to the width, and bad
    shapes raise."""
    jm, hashes, strand = case_inputs(1, True, False, 3, 4096, 1)
    m = port_copy(jm)
    m.data.zero_()
    h = u64.from_numpy(hashes)
    st = torch.from_numpy(strand)
    ok = mibf_random_insert.random_insert_plain(
        m.bv_words, m.cum_ranks, m.rank_dir, m.data, h, m.size, 0x105, 1, st)
    assert ok.all()
    vals = set(m.data[m.data != 0].tolist())
    assert vals <= {0x05, 0x05 | m.s_strand} and len(vals) == 2
    with pytest.raises(ValueError):
        mibf_random_insert.random_insert_plain(
            m.bv_words, m.cum_ranks, m.rank_dir, m.data, h, m.size, 1, 1,
            st[:, :2])
    with pytest.raises(ValueError):
        mibf_random_insert.random_insert_plain(
            m.bv_words, m.cum_ranks, m.rank_dir, m.data, h, m.size, 1, 0)
    with pytest.raises(NotImplementedError):
        mibf_construct.insert_random_order_device(
            dataclasses.replace(m, data_width=8), h, 1, 1)


@pytest.fixture(scope="module")
def strand_filter():
    """The JAX test's width-1 filter whose IDs carry the strand bit: 90
    frames, IDs 1-3 by the host mirror with strand."""
    size, h = 2048, 3
    rng = np.random.default_rng(21)
    hashes = rng.integers(0, 1 << 64, size=(90, h), dtype=np.uint64)
    strand = np.random.default_rng(3).random((90, h)) < 0.5
    st = jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=11, hash_num=h, occupancy=0.5, sseeds=())
    st = jax_construct.insert_bv(st, jax_u64.from_numpy(hashes))
    jm, _ = jax_construct.get_empty_mibf(st, data_width=1)
    m = port_copy(jm)
    for idv, lo in [(1, 0), (2, 30), (3, 60)]:
        jm, jok = jax_construct.insert_random_order(
            jm, hashes[lo: lo + 30], idv, 1, strand=strand[lo: lo + 30])
        _, ok = mibf_construct.insert_random_order(
            m, hashes[lo: lo + 30], idv, 1, strand=strand[lo: lo + 30])
        np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], np.asarray(jm.data))
    return jm, m, hashes


@pytest.mark.parametrize("num_ids,allowed_miss", [(4, 0), (70, 0), (70, 1),
                                                  (200, 2)])
def test_strand_statistics_match_jax(strand_filter, num_ids, allowed_miss):
    jm, m, _ = strand_filter
    # two saturated entries, one carrying the strand bit, and s_mask alone
    # (not above s_mask: not saturated)
    d = np.asarray(jm.data).copy()
    d[[3, 9, 27]] = [0x80 | 0x41, 0x80 | 0x02, 0x80]
    jm = dataclasses.replace(jm, data=jnp.asarray(d))
    m = mibf.from_numpy(np.asarray(jm.bv_words), d, size=m.size,
                        hash_num=m.hash_num, kmer_size=m.kmer_size,
                        data_width=1, device="cpu")
    jc, jsat = jax_mibf.get_id_counts_strand(jm, num_ids)
    c, sat = mibf.get_id_counts_strand(m, num_ids)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert sat == int(jsat) == 2
    jp, jprop = jax_mibf.calc_frame_probs_strand(jm, num_ids, allowed_miss)
    p, prop = mibf.calc_frame_probs_strand(m, num_ids, allowed_miss)
    np.testing.assert_allclose(p, jp, rtol=1e-12, atol=0)
    assert prop == pytest.approx(jprop, rel=1e-12)
    # the whole table, index 0 included, normalises
    total = int(c.sum())
    assert total > int(c[1:].sum()) or num_ids == 4
    assert prop == float(sat) / total


def test_strand_carrying_classification_matches_jax(strand_filter):
    """Values with the strand bit (id | s_strand, 64-67 at width 1) are
    table entries of their own; the port's engine against the JAX one."""
    jm, m, hashes = strand_filter
    assert m.s_strand == 64
    num_ids = 70
    pfp = [0.0] + [0.1] * (num_ids - 1)
    kw = dict(per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=10**6,
              max_miss=0, min_count=1, best_hit_agree=False)
    jqs = jax_query.MIBFQuerySupport(m=jm, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, **kw)
    mc = np.full(num_ids, 1, np.int32)
    frames = hashes[30:60]
    jres = jqs.query(jax_u64.from_numpy(frames), np.ones(30, bool), mc)
    res = qs.query(u64.from_numpy(frames), torch.ones(30, dtype=torch.bool),
                   mc)
    assert [dataclasses.astuple(r) for r in res] == \
        [dataclasses.astuple(r) for r in jres]
    assert (qs.sat_count, qs.eval_count) == (jqs.sat_count, jqs.eval_count)
    data = mibf.to_numpy(m)[2]
    assert (data >= 64).any() and ((data > 0) & (data < 64)).any()
    tables = mibf_query.query_device(m, u64.from_numpy(frames),
                                     torch.ones(30, dtype=torch.bool), mc, 0,
                                     num_ids, 10**6)
    totals = tables["counts"][:, 2]
    assert totals[64:].sum() > 0 and totals[1:64].sum() > 0


SCHEDULE_KINDS = ["one_kmer", "repeats", "unset_bits", "past_last_bit",
                  "repeated_slots", "invalid_interleaved"]


def schedule_inputs(kind, width):
    """(JAX filter, hashes uint64 [n, h], strand, valid, max_count) of one
    adversarial schedule case at h = 4 in a 4096-bit vector; the cases at
    max_count 1 but one_kmer start from pre-set and pre-saturated entries
    (at max_count 2 those reach the reference's assert)."""
    rng = np.random.default_rng(SCHEDULE_KINDS.index(kind) * 10 + width)
    size, h = 4096, 4
    distinct = rng.integers(0, 1 << 64, size=(60, h), dtype=np.uint64)
    strand = None
    valid = None
    maxc = 1
    built = distinct
    if kind == "one_kmer":
        hashes = np.repeat(distinct[:1], 300, axis=0)
        strand = np.repeat(rng.random((1, h)) < 0.5, 300, axis=0)
    elif kind == "repeats":
        idx = np.repeat(np.arange(40), rng.integers(2, 65, size=40))
        hashes = distinct[rng.permutation(idx)]
        maxc = 2
    elif kind == "unset_bits":
        # positions mostly unset, below the last set bit: each slot reads
        # the rank of the next set bit, which other slots alias
        last = int((distinct % np.uint64(size)).max())
        hashes = rng.integers(0, last, size=(200, h), dtype=np.uint64)
        hashes = hashes[rng.integers(0, 200, size=400)]
        strand = rng.random(hashes.shape) < 0.5
    elif kind == "past_last_bit":
        # set bits only in the low half; slots in the high half rank d_size
        built = rng.integers(0, size // 2, size=(60, h), dtype=np.uint64)
        hashes = np.where(rng.random((300, h)) < 0.4,
                          rng.integers(size // 2, size, size=(300, h),
                                       dtype=np.uint64),
                          built.reshape(-1)[rng.integers(0, 60 * h,
                                                         size=(300, h))])
        maxc = 2
    elif kind == "repeated_slots":
        hashes = distinct[rng.integers(0, 60, size=300)].copy()
        hashes[:, 2] = hashes[:, 0]
        hashes[::3, 3] = hashes[::3, 1]
        strand = rng.random(hashes.shape) < 0.5
    else:
        hashes = distinct[rng.integers(0, 60, size=400)]
        strand = rng.random(hashes.shape) < 0.5
        valid = rng.random(400) < 0.7
    st = jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=5, hash_num=h, occupancy=0.5, sseeds=())
    st = jax_construct.insert_bv(st, jax_u64.from_numpy(built))
    jm, _ = jax_construct.get_empty_mibf(st, data_width=width)
    if kind != "one_kmer" and maxc == 1:
        d0 = np.asarray(jm.data).copy()
        d0[rng.integers(0, len(d0), size=len(d0) // 3)] = 5
        d0[rng.integers(0, len(d0), size=len(d0) // 7)] = jm.s_mask | 5
        jm = dataclasses.replace(jm, data=jnp.asarray(d0))
    return jm, hashes, strand, valid, maxc


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("kind", SCHEDULE_KINDS)
def test_round_schedule_replay_matches_jax(kind, width):
    """The kernel's rounds, replayed with each round's frames in reverse
    index order (any order inside a round must do), then the tail in
    order, give the JAX host mirror's IDs and success flags."""
    jm, hashes, strand, valid, maxc = schedule_inputs(kind, width)
    m = port_copy(jm)
    h = u64.from_numpy(hashes)
    st = None if strand is None else torch.from_numpy(strand)
    v = None if valid is None else torch.from_numpy(valid)
    keys = mibf_random_insert.slot_keys(m.bv_words, m.cum_ranks, m.rank_dir,
                                        h, m.size, m.d_size)
    sched = mibf_random_insert.round_schedule(keys, v)
    n = hashes.shape[0]
    rounds = int(sched.max()) + 1
    for r in range(rounds):
        frames = torch.nonzero(sched == r).reshape(-1)
        assert frames.numel()
        pairs = torch.unique(torch.stack([
            frames[:, None].expand(-1, keys.shape[1]), keys[frames]], -1)
            .reshape(-1, 2), dim=0)
        # no two frames of a round share a key
        assert torch.unique(pairs[:, 1]).numel() == pairs.shape[0]
    order = [f for r in range(rounds)
             for f in reversed(torch.nonzero(sched == r).reshape(-1).tolist())]
    order += torch.nonzero(sched == mibf_random_insert.TAIL).reshape(-1) \
        .tolist()
    counts = torch.zeros(3, dtype=torch.int32)
    ok = mibf_random_insert.random_insert_plain(
        m.bv_words, m.cum_ranks, m.rank_dir, m.data, h, m.size, 9, maxc, st,
        v, schedule=counts, order=order)
    assert tuple(counts.tolist()) == \
        mibf_random_insert.schedule_counts(sched)
    if kind == "one_kmer":      # frame 0 alone, then the tail
        assert sched[0] == 0 and (sched[1:] == mibf_random_insert.TAIL).all()
    if kind == "repeats":       # chains as deep as the repeats
        assert rounds > 2
    if valid is not None:
        assert (sched[~v] == mibf_random_insert.INVALID).all()
        assert not ok[~v].any()
    if kind == "past_last_bit":
        assert (keys == m.d_size - 1).any()
        if width != 2:
            return
        jb, sb = jax_construct.insert_random_order_device(
            jm, jax_u64.from_numpy(hashes), 9, maxc)
        expect, expect_ok = np.asarray(jb.data), np.asarray(sb)
    else:
        keep = np.ones(n, bool) if valid is None else valid
        ja, sa = jax_construct.insert_random_order(
            jm, hashes[keep], 9, maxc,
            strand=None if strand is None else strand[keep])
        expect = np.asarray(ja.data)
        expect_ok = np.zeros(n, bool)
        expect_ok[keep] = np.asarray(sa)
    np.testing.assert_array_equal(mibf.to_numpy(m)[2], expect)
    np.testing.assert_array_equal(ok.numpy(), expect_ok)
