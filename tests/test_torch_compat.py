"""The port's reference-API facade (``btl_bloomfilter_tpu_torch.compat``)
against the JAX package's (``btl_bloomfilter_tpu.compat``): every case of
tests/test_compat.py run through both facades on the same seeded inputs,
plus the width-8 MIBF stack (an ID above 2**32), the MIBF constructor over
a bit vector, incrementAll and the counters' accessors.

Results are held bitwise (integers, bools, bytes, ranked result lists),
except the FPRs the JAX package computes in float32 (``getFPR``, ``FPR``,
``filtered_FPR``), held within float32 rounding (rel 1e-6) of the port's
double; the facades' pure-Python FPR formulas are compared exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import compat as jcompat
from btl_bloomfilter_tpu.ops import nthash, nthash_tables
from btl_bloomfilter_tpu.utils import binomial as jax_binomial
from btl_bloomfilter_tpu_torch import compat
from btl_bloomfilter_tpu_torch.models import mibf
from btl_bloomfilter_tpu_torch.utils import binomial

torch.set_num_threads(1)

BIG_ID = (37 << 40) | 12345
F32 = 1e-6          # float32 rounding of the JAX package's FPRs


def hash_rows(seq, k, h):
    f = nthash.hash_frames(nthash_tables.encode_seq(seq), k, h)
    valid = np.asarray(f.valid)
    return f.hashes.astype_numpy()[valid]


def same_bytes(a, b):
    assert open(a, "rb").read() == open(b, "rb").read()


def test_bloom_unit_fixture(tmp_path):
    """tests/test_compat.py's BloomFilterTests.cpp fixture, both facades."""
    rows = hash_rows("ACGTAC", 4, 5)
    jb = jcompat.BloomFilter(10**6, 5, 4)
    pb = compat.BloomFilter(10**6, 5, 4, device="cpu")
    for row in rows:
        jb.insert(row)
        pb.insert(row)
    assert all(pb.contains(row) for row in rows)
    assert pb.getPop() == jb.getPop()
    jp, pp = str(tmp_path / "j.bf"), str(tmp_path / "p.bf")
    jb.storeFilter(jp)
    pb.storeFilter(pp)
    same_bytes(jp, pp)
    loaded = compat.BloomFilter(jp, device="cpu")
    assert loaded.getFilterSize() == 10**6
    assert loaded.sizeInBytes() == 125000
    assert all(loaded.contains(row) for row in rows)
    pb.loadFilter(jp)
    assert pb.getPop() == jb.getPop()
    assert (pb.getHashNum(), pb.getKmerSize()) == (jb.getHashNum(),
                                                   jb.getKmerSize())


@pytest.mark.parametrize("width", [1, 8])
def test_counting_unit_fixture(tmp_path, width):
    """tests/test_compat.py's CountingBloomFilterTests.cpp fixture, plus
    insertAndCheck, incrementAll and the counter accessors."""
    rows = hash_rows("ACGTACACTGGACTGAGTCT", 8, 5)
    jc = jcompat.CountingBloomFilter(100001, 5, 8, 1, counter_width=width)
    pc = compat.CountingBloomFilter(100001, 5, 8, 1, counter_width=width,
                                    device="cpu")
    assert pc.sizeInBytes() == jc.sizeInBytes() == 100008
    assert pc.size() == jc.size()
    for row in rows:
        jc.insert(row)
        pc.insert(row)
    for row in rows:
        assert pc.contains(row) == jc.contains(row) is True
        assert pc.minCount(row) == jc.minCount(row) >= 1
    assert pc.insertAndCheck(rows[0]) == jc.insertAndCheck(rows[0]) is True
    pc.incrementAll(rows[:3])
    jc.incrementAll(rows[:3])
    for row in rows:
        assert pc.minCount(row) == jc.minCount(row)
    idx = np.unique((rows[:6].astype(np.uint64)
                     % np.uint64(pc.size())).astype(np.int64))
    for i in list(idx) + [0, pc.size() - 1]:
        assert pc[int(i)] == jc[int(i)]
    assert pc.popCount() == jc.popCount()
    assert pc.filtered_popcount() == jc.filtered_popcount()
    assert pc.FPR() == pytest.approx(jc.FPR(), rel=F32)
    assert pc.filtered_FPR() == pytest.approx(jc.filtered_FPR(), rel=F32)
    assert (pc.getKmerSize(), pc.getHashNum(), pc.threshold()) == (
        jc.getKmerSize(), jc.getHashNum(), jc.threshold())
    jp, pp = str(tmp_path / f"j{width}.bf"), str(tmp_path / f"p{width}.bf")
    jc.storeFilter(jp)
    pc.storeFilter(pp)
    same_bytes(jp, pp)
    loaded = compat.CountingBloomFilter(jp, 1, device="cpu")
    for row in rows:
        assert loaded.contains(row)
        assert loaded.minCount(row) == pc.minCount(row)
    pc.loadFilter(jp)
    assert pc.popCount() == jc.popCount()


def test_kmer_bloom_string_api():
    filters = (jcompat.KmerBloomFilter(8000, 3, 5),
               compat.KmerBloomFilter(8000, 3, 5, device="cpu"))
    for mod, kbf in zip((jcompat, compat), filters):
        kbf.insert("TAGAA")            # one k-mer (KmerBloomFilter.hpp:63)
        mod.insertSeq(kbf, "CCCAAAGACCC")   # a whole sequence
    jk, pk = filters
    for kmer in ("TAGAA", "CCCAA", "GGGGG", "AAAGA", "TTTTT"):
        assert pk.contains(kmer) == jk.contains(kmer)
    assert pk.contains("TAGAA") and pk.contains("CCCAA")
    assert not pk.contains("GGGGG")
    assert pk.getPop() == jk.getPop()


def test_insert_and_check():
    for bloom in (jcompat.BloomFilter(512, 2, 4),
                  compat.BloomFilter(512, 2, 4, device="cpu")):
        assert not bloom.insertAndCheck([1, 2])
        assert bloom.insertAndCheck([1, 2])


def test_fpr_helpers():
    jb = jcompat.BloomFilter(1000, 0.01, 0, 5)
    pb = compat.BloomFilter(1000, 0.01, 0, 5, device="cpu")
    assert pb.getHashNum() == jb.getHashNum() == 6  # calcOptiHashNum(0.01)
    assert pb.getFilterSize() == jb.getFilterSize()
    for args in ((10000, 100, 3), (1 << 20, 5000, 4), (64, 2, 1)):
        assert compat.calcApproxFPR(*args) == jcompat.calcApproxFPR(*args)
        assert compat.calcRedunancyFPR(*args) == \
            jcompat.calcRedunancyFPR(*args)
    assert compat.calcApproxFPR(10000, 100, 3) > 0
    assert compat.calcRedunancyFPR(10000, 100, 3) > 0
    # getFPR_numEle / getRedudancyFPR over nEntry, getFPR after inserts
    rows = np.random.default_rng(4).integers(0, 1 << 64, size=(300, 6),
                                             dtype=np.uint64)
    for b in (jb, pb):
        b.insert(rows)
        b.setnEntry(300)
        b.settEntry(7)
    assert (pb.getnEntry(), pb.gettEntry()) == (jb.getnEntry(),
                                                jb.gettEntry())
    assert pb.getFPR_numEle() == jb.getFPR_numEle()
    assert pb.getRedudancyFPR() == jb.getRedudancyFPR()
    assert pb.getPop() == jb.getPop()
    assert pb.getFPR() == pytest.approx(jb.getFPR(), rel=F32)


# ---------------------------------------------------------------------------
# the MIBF stack
# ---------------------------------------------------------------------------

def results(res):
    return [dataclasses.astuple(r) for r in res]


def build_both(width, ids):
    """tests/test_compat.py's facade build on both sides: (hashes, [(jax
    cs, m), (port cs, m)], insertBVColli counts)."""
    rng = np.random.default_rng(0)
    hashes = rng.integers(0, 1 << 64, size=(100, 4), dtype=np.uint64)
    out, colli = [], []
    for mod, kw in ((jcompat, {}), (compat, {"device": "cpu"})):
        cs = mod.MIBFConstructSupport(200, 11, 4, 0.5, **kw)
        cs.insertBV(hashes[:50])
        colli.append(cs.insertBVColli(hashes[50:]))
        m = cs.getEmptyMIBF(width)
        cs.insertMIBF(m, hashes[:50], ids[0])
        cs.insertMIBF(m, hashes[50:], ids[1])
        cs.insertSaturation(m, hashes[:50], ids[0])
        out.append((cs, m))
    return hashes, out, colli


def same_filter(jm, pm):
    np.testing.assert_array_equal(mibf.to_numpy(pm._m)[2],
                                  np.asarray(jm._m.data))
    np.testing.assert_array_equal(mibf.to_numpy(pm._m)[0],
                                  np.asarray(jm._m.bv_words))


def test_mibf_facade_full_pipeline(tmp_path):
    hashes, ((jcs, jm), (pcs, pm)), colli = build_both(2, (1, 2))
    assert colli[0] == colli[1] >= 0
    same_filter(jm, pm)
    np.testing.assert_array_equal(pcs._counts.numpy().view(np.uint16),
                                  np.asarray(jcs._counts))
    assert pm.getPop() == jm.getPop() > 0
    assert pm.getPopNonZero() == jm.getPopNonZero() > 0
    assert pm.getPopSaturated() == jm.getPopSaturated()

    for row in (hashes[0], hashes[60], hashes[99]):
        jv, jok, jsat = jm.at(row)
        pv, pok, psat = pm.at(row)
        np.testing.assert_array_equal(pv, jv)
        assert (pok, psat) == (jok, jsat)
        jhit, jr = jm.atRank(row)
        phit, pr = pm.atRank(row)
        assert phit == jhit
        np.testing.assert_array_equal(pr, jr)
        assert pm.getRankPos(int(row[0])) == jm.getRankPos(int(row[0])) \
            == pr[0]
        assert pm.getData(int(pr[0])) == jm.getData(int(jr[0]))
    vals, ok, sat = pm.at(hashes[0])
    assert ok and len(vals) == 4

    for n_ids, miss in ((3, 0), (5, 1)):
        assert pm.calcFrameProbs(n_ids, miss) == jm.calcFrameProbs(n_ids,
                                                                   miss)
        assert pm.calcFrameProbsStrand(n_ids, miss) == \
            jm.calcFrameProbsStrand(n_ids, miss)
    pc, ps = pm.getIDCounts(3)
    jc, js = jm.getIDCounts(3)
    np.testing.assert_array_equal(pc, np.asarray(jc))
    assert ps == js

    qss = [mod.MIBFQuerySupport(m, [0.0, 0.1, 0.1], 2, 10**6, 0, 1, False)
           for mod, m in ((jcompat, jm), (compat, pm))]
    mc = np.ones(3, np.int32)
    jres, pres = (qs.query(hashes[:50], mc) for qs in qss)
    assert results(pres) == results(jres) and pres[0].id == 1
    assert qss[1].getSatCount() == qss[0].getSatCount()
    assert qss[1].getEvaluatedValues() == qss[0].getEvaluatedValues()
    jres2, pres2 = (qs.queryPaired(hashes[50:70], hashes[70:100], mc)
                    for qs in qss)
    assert results(pres2) == results(jres2) and pres2[0].id == 2
    valid = np.arange(30) % 7 != 3
    for v in (None, valid):
        jsig, psig = (qs.getMatchSignature(hashes[:30], v) for qs in qss)
        for a, b in zip(psig, jsig):
            np.testing.assert_array_equal(a, b)
    assert psig[1] == int(valid.sum())
    assert qss[1].calcSat(10, 0.2, 0) == 0.0
    for args in ((10, 0.2, 3), (100, 0.05, 9), (7, 0.5, 7)):
        assert qss[1].calcSat(*args) == qss[0].calcSat(*args) \
            == binomial.calc_sat(*args) == jax_binomial.calc_sat(*args)

    # store / load round trip, then the random-order insert and saturate
    jp, pp = str(tmp_path / "j.mibf"), str(tmp_path / "p.mibf")
    jm.store(jp)
    pm.store(pp)
    for ext in ("", ".sdsl"):
        same_bytes(jp + ext, pp + ext)
    jm2 = jcompat.MIBloomFilter(jp)
    pm2 = compat.MIBloomFilter(jp, device="cpu")
    assert pm2.getPop() == jm2.getPop() == pm.getPop()
    assert (pm2.getKmerSize(), pm2.getHashNum(), pm2.size(),
            pm2.getSeedValues()) == (11, 4, jm2.size(),
                                     tuple(jm2.getSeedValues()))
    assert pm2.insert(hashes[0], 3, 1) == jm2.insert(hashes[0], 3, 1)
    strand = np.array([[True, False, True, False]] * 3)
    np.testing.assert_array_equal(
        pm2.insert(hashes[10:13], strand, 4, 1),
        jm2.insert(hashes[10:13], strand, 4, 1))
    jm2.saturate(hashes[1])
    pm2.saturate(hashes[1])
    same_filter(jm2, pm2)
    assert pm2.getPopSaturated() == jm2.getPopSaturated() > 0
    rank = int(pm2.atRank(hashes[2])[1][0])
    jm2.setData(rank, 3)
    pm2.setData(rank, 3)
    same_filter(jm2, pm2)


def test_mibf_facade_width8(tmp_path):
    """The facade over a width-8 filter with an ID above 2**32: build,
    lookups, statistics, setData and the .mibf bytes equal the JAX
    facade's; the random-order insert and classification raise, as the
    reference has neither at width 8."""
    hashes, ((jcs, jm), (pcs, pm)), colli = build_both(8, (BIG_ID, 2))
    assert colli[0] == colli[1]
    same_filter(jm, pm)
    np.testing.assert_array_equal(pcs._counts.numpy().view(np.uint32),
                                  np.asarray(jcs._counts))
    assert pm.getPopNonZero() == jm.getPopNonZero() > 0
    assert pm.getPopSaturated() == jm.getPopSaturated()
    for row in (hashes[0], hashes[60]):
        jhit, jr = jm.atRank(row)
        phit, pr = pm.atRank(row)
        assert phit == jhit
        np.testing.assert_array_equal(pr, jr)
        assert pm.getRankPos(int(row[0])) == jm.getRankPos(int(row[0]))
        # the JAX facade reads a width-8 entry's low limb only: compare
        # with its two planes
        planes = np.asarray(jm._m.data)
        assert pm.getData(int(pr[0])) == int(planes[0, jr[0]]) | (
            int(planes[1, jr[0]]) << 32)
        pv, pok, psat = pm.at(row)
        assert pok and pv.dtype == np.uint64
    assert (pm.at(hashes[0])[0] == np.uint64(BIG_ID)).any()
    for n_ids in (3, 9):
        assert pm.calcFrameProbs(n_ids, 0) == jm.calcFrameProbs(n_ids, 0)
        assert pm.calcFrameProbsStrand(n_ids, 0) == \
            jm.calcFrameProbsStrand(n_ids, 0)
    rank = int(pm.atRank(hashes[0])[1][1])
    jm.setData(rank, 5)
    pm.setData(rank, BIG_ID + 9)
    assert pm.getData(rank) == BIG_ID + 9
    pm.setData(rank, 5)
    same_filter(jm, pm)
    jp, pp = str(tmp_path / "j8.mibf"), str(tmp_path / "p8.mibf")
    jm.store(jp)
    pm.store(pp)
    for ext in ("", ".sdsl"):
        same_bytes(jp + ext, pp + ext)
    pm2 = compat.MIBloomFilter(jp, data_width=8, device="cpu")
    same_filter(jcompat.MIBloomFilter(jp, data_width=8), pm2)
    with pytest.raises(NotImplementedError):
        jm.insert(hashes[0], 3, 1)
    with pytest.raises(NotImplementedError):
        pm.insert(hashes[0], 3, 1)
    qs = compat.MIBFQuerySupport(pm, [0.0, 0.1, 0.1], 2, 10**6, 0, 1, False)
    with pytest.raises(NotImplementedError):
        qs.query(hashes[:50], np.ones(3, np.int32))


@pytest.mark.parametrize("width", [2, 8])
def test_mibf_from_bit_vector(width):
    """MIBloomFilter(hashNum, kmerSize, bv) over uint32 words and over a
    construct state: the same frozen filter as the JAX facade's."""
    hashes = np.random.default_rng(6).integers(0, 1 << 64, size=(40, 3),
                                               dtype=np.uint64)
    jcs = jcompat.MIBFConstructSupport(80, 9, 3, 0.5)
    pcs = compat.MIBFConstructSupport(80, 9, 3, 0.5, device="cpu")
    jcs.insertBV(hashes)
    pcs.insertBV(hashes)
    words = np.asarray(jcs._state.bv_words)
    for jm, pm in (
            (jcompat.MIBloomFilter(3, 9, words, data_width=width),
             compat.MIBloomFilter(3, 9, words, data_width=width,
                                  device="cpu")),
            (jcompat.MIBloomFilter(3, 9, jcs._state, data_width=width),
             compat.MIBloomFilter(3, 9, pcs._state, data_width=width))):
        same_filter(jm, pm)
        assert (pm.getPop(), pm.size(), pm.getHashNum()) == (
            jm.getPop(), jm.size(), jm.getHashNum())
        np.testing.assert_array_equal(mibf.to_numpy(pm._m)[1],
                                      np.asarray(jm._m.cum_ranks))
