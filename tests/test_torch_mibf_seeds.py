"""The port's spaced-seed MIBF path (plain PyTorch) against the JAX package:
the seeded 4-phase build and the engine's spaced-seed (st) mode with
``max_miss`` 0-2 on the inputs of the JAX tests (tests/test_mibf_query.py,
the miss-tolerant block), ``api.HashPipeline`` and
``api.MIBFConstructPipeline`` with seeds (and the reference's total-h
quirk), the ``build_mibf -s`` / ``classify`` CLIs against the JAX package
driven in-process as its CLIs drive it (byte-equal ``.mibf`` / ``.sdsl``,
equal output lines), and the seeded ``.mibf`` round trip.

Inputs are made with numpy from fixed seeds and handed to both sides.
Compared outputs are integers, bools, bytes or text (each result's
``frame_prob`` is copied by both sides from one per-ID list): the tolerance
is zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import api as jax_api
from btl_bloomfilter_tpu.io import mibf_format as jax_mibf_format
from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.models import mibf_query as jax_query
from btl_bloomfilter_tpu.ops import nthash_tables as jax_tables
from btl_bloomfilter_tpu.ops import seeds as jax_seeds
from btl_bloomfilter_tpu_torch import api
from btl_bloomfilter_tpu_torch.io import mibf_format
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct, mibf_query
from btl_bloomfilter_tpu_torch.ops import seeds, u64
from btl_bloomfilter_tpu_torch.tools import build_mibf, classify

torch.set_num_threads(1)

# the JAX tests' seeds (a palindrome, twice) and a mirrored pair
JAX_TEST_SEEDS = ["110110111011011", "110110111011011"[::-1]]
MIRRORED = ["1101111011111", "1111101111011"]


def result_fields(res):
    return [dataclasses.astuple(r) for r in res]


def mutate(codes, positions, rng):
    out = codes.copy()
    for p in positions:
        out[p] = (out[p] + rng.integers(1, 4)) % 4
    return out


@pytest.fixture(scope="module")
def spaced():
    """The JAX test's spaced-seed filter (3 references of 90 bases, m2 = 2,
    4096 bits), built eagerly by both packages phase by phase."""
    rng = np.random.default_rng(7)
    refs = [rng.integers(0, 4, size=90, dtype=np.uint8) for _ in range(3)]
    k, h, size = 15, 4, 4096
    jst = jax_construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=k, hash_num=h, occupancy=0.5, sseeds=tuple(JAX_TEST_SEEDS))
    jfr = [jax_seeds.spaced_hash_frames(r, JAX_TEST_SEEDS, 2) for r in refs]
    for fr in jfr:
        jst = jax_construct.insert_bv(jst, fr.hashes, valid=fr.valid)
    jm, jcounts = jax_construct.get_empty_mibf(jst)
    for i, fr in enumerate(jfr):
        jm, jcounts = jax_construct.insert_mibf(jm, jcounts, fr.hashes, i + 1,
                                                valid=fr.valid)
    for i, fr in enumerate(jfr):
        jm, jcounts = jax_construct.insert_saturation(
            jm, jcounts, fr.hashes, i + 1, valid=fr.valid)

    st = mibf_construct.BitVectorState(
        bv_words=torch.zeros(size // 32, dtype=torch.int32), filter_size=size,
        kmer_size=k, hash_num=h, occupancy=0.5, sseeds=tuple(JAX_TEST_SEEDS))
    frs = [seeds.spaced_hash_frames(torch.from_numpy(r), JAX_TEST_SEEDS, 2)
           for r in refs]
    for fr in frs:
        mibf_construct.insert_bv(st, fr.hashes, fr.valid)
    m, counts = mibf_construct.get_empty_mibf(st)
    for i, fr in enumerate(frs):
        mibf_construct.insert_mibf(m, counts, fr.hashes, i + 1, fr.valid)
    for i, fr in enumerate(frs):
        mibf_construct.insert_saturation(m, counts, fr.hashes, i + 1,
                                         fr.valid)
    return jm, jcounts, m, counts, refs


def test_seeded_build_matches_jax(spaced):
    jm, jcounts, m, counts, _ = spaced
    bv, cum, data = mibf.to_numpy(m)
    np.testing.assert_array_equal(bv, np.asarray(jm.bv_words))
    np.testing.assert_array_equal(cum, np.asarray(jm.cum_ranks))
    np.testing.assert_array_equal(data, np.asarray(jm.data))
    np.testing.assert_array_equal(counts.numpy().view(np.uint16),
                                  np.asarray(jcounts))
    assert m.sseeds == tuple(JAX_TEST_SEEDS) and m.d_size == jm.d_size
    assert (data > 0).sum() > 100


@pytest.mark.parametrize("max_miss", [0, 1, 2])
def test_st_mode_query_matches_jax(spaced, max_miss):
    """Mutated reads of reference 2 (frames with misses reach the engine
    when max_miss > 0), one at a time and as a batch."""
    jm, _, m, _, refs = spaced
    num_ids = 5
    pfp = [0.0] + [0.1] * (num_ids - 1)
    kw = dict(per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=10**6,
              max_miss=max_miss, min_count=1, best_hit_agree=False)
    jqs = jax_query.MIBFQuerySupport(m=jm, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, **kw)
    mc = np.full(num_ids, 1, np.int32)
    rng = np.random.default_rng(max_miss * 11 + 1)
    reads = [mutate(refs[1][10:70], [20, 37], rng),
             mutate(refs[0][5:65], [9], rng), refs[2][30:90]]
    singles = []
    for read in reads:
        jfr = jax_seeds.spaced_hash_frames(read, JAX_TEST_SEEDS, m2=2)
        fr = seeds.spaced_hash_frames(torch.from_numpy(read), JAX_TEST_SEEDS,
                                      2)
        jres = jqs.query(jfr.hashes, jfr.valid, mc)
        res = qs.query(fr.hashes, fr.valid, mc)
        assert result_fields(res) == result_fields(jres)
        assert (qs.sat_count, qs.eval_count) == (jqs.sat_count,
                                                 jqs.eval_count)
        singles.append(result_fields(res))
    assert singles[0] and singles[0][0][0] == 2
    fr = seeds.spaced_hash_frames(torch.from_numpy(np.stack(reads)),
                                  JAX_TEST_SEEDS, 2)
    many = qs.query_many(fr.hashes, fr.valid, mc)
    assert [result_fields(r) for r in many] == singles
    # the engine saw partial frames: misses within max_miss
    _, hit, _ = mibf.at_rank_data(m, fr.hashes)
    misses = (~hit).sum(-1)[fr.valid]
    assert ((misses > 0) & (misses <= 2)).any()


def test_hash_pipeline_with_seeds_matches_jax():
    """Three seeds at h = 7: m2 = max(1, 7 // 3) = 2, so a frame holds 6
    hashes (the reference's total-h quirk)."""
    seed_strings = ("110110111", "111010011", "101111101")
    rng = np.random.default_rng(2)
    reads = [rng.integers(0, 5, size=n, dtype=np.uint8)
             for n in (50, 120, 8, 70)]
    jhp = jax_api.HashPipeline(9, 7, seed_strings)
    hp = api.HashPipeline(9, 7, seed_strings, device="cpu")
    jfr, fr = jhp.frames_batch(reads), hp.frames_batch(reads)
    assert fr.hashes.shape == (4, 128 - 9 + 1, 6)
    np.testing.assert_array_equal(u64.to_numpy(fr.hashes),
                                  jfr.hashes.astype_numpy())
    np.testing.assert_array_equal(fr.strand.numpy(), np.asarray(jfr.strand))
    np.testing.assert_array_equal(fr.valid.numpy(), np.asarray(jfr.valid))
    assert not fr.valid[2].any()          # shorter than k
    one, jone = hp.frames(reads[1]), jhp.frames(reads[1])
    np.testing.assert_array_equal(u64.to_numpy(one.hashes),
                                  jone.hashes.astype_numpy())
    np.testing.assert_array_equal(one.strand.numpy(),
                                  np.asarray(jone.strand))
    assert hp.frames(reads[2]) is None and jhp.frames(reads[2]) is None


def test_construct_pipeline_with_seeds_matches_jax():
    rng = np.random.default_rng(4)
    refs = [rng.integers(0, 4, size=int(n), dtype=np.uint8)
            for n in rng.integers(150, 400, size=5)]
    k = len(MIRRORED[0])
    jpipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=sum(map(len, refs)), k=k, hash_num=4,
        occupancy=0.5, spaced_seeds=MIRRORED))
    pipe = api.MIBFConstructPipeline(mibf_construct.create(
        sum(map(len, refs)), k, 4, 0.5, MIRRORED, device="cpu"))
    for r in refs:
        jpipe.insert_bv_seq(r)
        pipe.insert_bv_seq(r)
    jpipe.freeze(2)
    pipe.freeze(2)
    ids = list(range(1, len(refs) + 1))
    jpipe.insert_mibf_batch(refs, ids)
    pipe.insert_mibf_batch(refs, ids)
    jpipe.insert_saturation_seq(refs[0], 1)
    pipe.insert_saturation_seq(refs[0], 1)
    jpipe.insert_saturation_batch(refs[1:], ids[1:])
    pipe.insert_saturation_batch(refs[1:], ids[1:])
    bv, _, data = mibf.to_numpy(pipe.m)
    np.testing.assert_array_equal(bv, np.asarray(jpipe.m.bv_words))
    np.testing.assert_array_equal(data, np.asarray(jpipe.m.data))
    np.testing.assert_array_equal(pipe.counts.numpy().view(np.uint16),
                                  np.asarray(jpipe.counts))
    assert pipe.m.sseeds == tuple(MIRRORED)


def write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j: j + 60] + "\n")


def test_cli_build_and_classify_with_seeds_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(21)
    refs = ["".join(rng.choice(list("ACGT"), size=int(n)))
            for n in rng.integers(400, 700, size=5)]
    reads = []
    for i in range(12):
        ref = refs[i % len(refs)]
        o = int(rng.integers(0, len(ref) - 150))
        s = list(ref[o: o + 150])
        for j in rng.integers(0, 150, size=i % 4):
            s[j] = "ACGT"[("ACGT".index(s[j]) + 1) % 4]
        reads.append("".join(s))
    reads.append("ACGTACG")                        # shorter than k
    fa_refs, fa_reads = str(tmp_path / "refs.fa"), str(tmp_path / "reads.fa")
    write_fasta(fa_refs, [(f"ref{i}", s) for i, s in enumerate(refs)])
    write_fasta(fa_reads, [(f"read{i}", s) for i, s in enumerate(reads)])
    out = str(tmp_path / "port.mibf")
    build_mibf.main(["-f", fa_refs, "-k", "99", "-g", "4", "-s",
                     ",".join(MIRRORED), "-o", out, "--device", "cpu"])
    classify.main(["-f", fa_reads, "-b", out, "-m", "2", "--max-miss", "1",
                   "--batch", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    lines = lines[lines.index(f"wrote {out} (+.sdsl, +.ids)") + 1:]

    # the JAX package in-process, as tools/build_mibf.py -s and
    # tools/classify.py drive it (k taken from the seeds)
    k = len(MIRRORED[0])
    codes = [jax_tables.encode_seq(s) for s in refs]
    pipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=sum(map(len, refs)), k=k, hash_num=4,
        occupancy=0.5, spaced_seeds=tuple(MIRRORED)))
    for c in codes:
        pipe.insert_bv_seq(c)
    pipe.freeze()
    ids = list(range(1, len(refs) + 1))
    pipe.insert_mibf_batch(codes, ids)
    pipe.insert_saturation_batch(codes, ids)
    ref = str(tmp_path / "jax.mibf")
    jax_mibf_format.store_mibf(pipe.m, ref)
    with open(ref + ".ids", "w") as f:
        for i in ids:
            f.write(f"{i}\tref{i - 1}\n")
    for ext in ("", ".sdsl", ".ids"):
        with open(out + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext

    jm = jax_mibf_format.load_mibf(ref)
    assert tuple(jm.sseeds) == tuple(MIRRORED)
    num_ids = len(refs) + 1
    pfp, _ = jax_mibf.calc_frame_probs(jm, num_ids, 1)
    jqs = jax_query.MIBFQuerySupport(
        m=jm, per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=10**6,
        max_miss=1, min_count=1, best_hit_agree=False)
    mc = np.full(num_ids, 2, np.int32)
    hp = jax_api.HashPipeline(jm.kmer_size, jm.hash_num, tuple(jm.sseeds))
    expect = []
    for i, s in enumerate(reads):
        if len(s) < k:
            expect.append(f"read{i}\t*\tshort")
            continue
        fr = hp.frames_batch([jax_tables.encode_seq(s)])
        res = jqs.query_many(fr.hashes, np.asarray(fr.valid), mc)[0]
        if not res:
            expect.append(f"read{i}\t*\tunclassified")
        else:
            r = res[0]
            expect.append(f"read{i}\t{r.id}\tref{r.id - 1}"
                          f"\tnsf={r.non_sat_frame_count}\tcount={r.count}"
                          f"\tsolid={r.solid_count}\tprob={r.frame_prob:.3g}")
    # batches of 5 reads; the short read is reported as it streams by
    assert lines == expect[:10] + expect[12:] + expect[10:12]
    assert sum(x.split("\t")[2] == f"ref{i % 5}"
               for i, x in enumerate(expect[:12])) >= 10


def test_seeded_mibf_round_trip(spaced, tmp_path):
    jm, _, m, _, _ = spaced
    path, jpath = str(tmp_path / "port.mibf"), str(tmp_path / "jax.mibf")
    mibf_format.store_mibf(m, path)
    jax_mibf_format.store_mibf(jm, jpath)
    for ext in ("", ".sdsl"):
        with open(path + ext, "rb") as a, open(jpath + ext, "rb") as b:
            assert a.read() == b.read(), ext
    back = mibf_format.load_mibf(jpath, device="cpu")
    assert back.sseeds == tuple(JAX_TEST_SEEDS)
    assert (back.size, back.hash_num, back.kmer_size, back.d_size) == (
        m.size, m.hash_num, m.kmer_size, m.d_size)
    for name in ("bv_words", "cum_ranks", "data"):
        assert torch.equal(getattr(back, name), getattr(m, name))
