"""The port's MIBF classification (plain PyTorch path) against the JAX
package: the two-pass engine ``query_frames_batch`` on adversarial frame
tables (saturated values, duplicate raws, misses, invalid frames, early
exits, out-of-range IDs, and an ID count past the JAX engine's uint32 key
guard), ``MIBFQuerySupport.query`` / ``query_many`` on a filter built by the
JAX package and carried across, and the ``build_mibf`` / ``classify`` CLIs
against the JAX package's pipeline and engine on the same FASTA; paired-end reads
(``query_paired`` / ``query_paired_many`` and the frame interleave) and
``get_match_signature`` on a plain k-mer filter and a spaced-seed one.

Inputs are made with numpy from fixed seeds and handed to both sides. All
compared outputs are integers, bools, bytes or text, except each result's
``frame_prob``, which both sides copy from the same per-ID list: the
tolerance is zero.
"""

import dataclasses

import jax
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
from btl_bloomfilter_tpu.ops.u64 import U64
from btl_bloomfilter_tpu_torch import api
from btl_bloomfilter_tpu_torch.models import mibf, mibf_query
from btl_bloomfilter_tpu_torch.tools import build_mibf, classify

torch.set_num_threads(1)

ENGINE_KEYS = ("counts", "candidates", "best", "sat_count", "eval_count")

# the JAX engine, jitted (eager JAX dispatches op by op and is slow on the
# CPU); one frame per scan step compiles fastest and gives the same tables
jax_query_frames_batch = jax.jit(jax_query.query_frames_batch,
                                 static_argnums=(6, 7),
                                 static_argnames=("st_mode", "chunk"))


def carry(jm):
    return mibf.from_numpy(np.asarray(jm.bv_words), np.asarray(jm.data),
                           size=jm.size, hash_num=jm.hash_num,
                           kmer_size=jm.kmer_size, data_width=jm.data_width,
                           device="cpu")


def small_filter(h, width=2):
    """A JAX-built filter (3 IDs, a few saturated entries) and its port
    copy; the engine tests only read its bit layout constants."""
    rng = np.random.default_rng(h)
    hashes = jnp.asarray(rng.integers(0, 1 << 32, size=(150, h, 2),
                                      dtype=np.uint32))
    st = jax_construct.BitVectorState(
        bv_words=jnp.zeros(1024 // 32, jnp.uint32), filter_size=1024,
        kmer_size=11, hash_num=h, occupancy=0.5, sseeds=())
    st = jax_construct.insert_bv(st, U64(hashes[..., 0], hashes[..., 1]))
    jm, _ = jax_construct.get_empty_mibf(st, width)
    return jm, carry(jm)


def frame_tables(seed, R, W, h, num_ids, smask, satfrac, missfrac, oor):
    """Adversarial frame tables as tests/test_mibf_query.py makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_ids, size=(R, W, h)).astype(np.uint32)
    if oor:
        alien = rng.random((R, W, h)) < 0.15
        ids = np.where(alien, ids + np.uint32(num_ids + 3), ids)
    sat = rng.random((R, W, h)) < satfrac
    raw = np.where(sat, ids | np.uint32(smask), ids)
    dup = rng.random((R, W)) < 0.3
    raw[dup, 1] = raw[dup, 0]
    hit = rng.random((R, W, h)) >= missfrac
    raw = np.where(hit, raw, 0)
    misses = (~hit).sum(axis=-1).astype(np.int32)
    valid = rng.random((R, W)) < 0.9
    usable = valid & (misses <= 1)
    mc = rng.integers(1, 4, size=num_ids).astype(np.int32)
    return raw, hit, usable, misses, mc, valid


def run_engines(jm, m, tables, num_ids, efl, st_mode=False):
    raw, hit, usable, misses, mc, valid = tables
    ev = None if st_mode else valid
    a = jax.device_get(jax_query_frames_batch(
        jm, jnp.asarray(raw), jnp.asarray(hit), jnp.asarray(usable),
        jnp.asarray(misses), jnp.asarray(mc), num_ids, efl,
        frame_eval=None if ev is None else jnp.asarray(ev),
        st_mode=st_mode, chunk=1))
    b = mibf_query.query_frames_batch(
        m, torch.from_numpy(raw.astype(np.int64)), torch.from_numpy(hit),
        torch.from_numpy(usable), torch.from_numpy(misses),
        torch.from_numpy(mc), num_ids, efl,
        frame_eval=None if ev is None else torch.from_numpy(ev),
        st_mode=st_mode)
    for k in ENGINE_KEYS:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                      err_msg=k)
    return b


@pytest.mark.parametrize("seed,R,W,h,num_ids,efl,satfrac,missfrac,oor,width", [
    (1, 3, 40, 4, 8, 10**6, 0.2, 0.0, False, 2),
    (2, 4, 57, 3, 8, 3, 0.3, 0.2, False, 2),       # early exit + misses
    (3, 2, 33, 4, 5, 0, 0.5, 0.3, True, 2),        # tiny efl + out-of-range
    (4, 5, 64, 2, 16, 7, 0.0, 0.0, False, 1),
    (5, 1, 128, 4, 64, 10**6, 0.1, 0.1, False, 4),
    (6, 3, 50, 3, 8, 2, 0.3, 0.1, True, 1),        # st mode (no frame bump)
])
def test_query_frames_batch_matches_jax(seed, R, W, h, num_ids, efl,
                                        satfrac, missfrac, oor, width):
    jm, m = small_filter(h, width)
    tables = frame_tables(seed, R, W, h, num_ids, jm.s_mask, satfrac,
                          missfrac, oor)
    out = run_engines(jm, m, tables, num_ids, efl, st_mode=seed == 6)
    assert out["candidates"].any()


def test_query_frames_batch_past_the_uint32_key_guard():
    """num_ids << bits(W*h) > 2**32: the JAX engine falls back to its
    dense-carry scan; the port's int64 keys need no fallback."""
    jm, m = small_filter(8)
    R, W, h, num_ids = 1, 513, 8, (1 << 20) + 1
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, size=(R, W, h)).astype(np.uint32)
    ids[..., 0] = rng.integers(0, num_ids, size=(R, W))
    sat = rng.random((R, W, h)) < 0.1
    raw = np.where(sat, ids | np.uint32(jm.s_mask), ids)
    hit = rng.random((R, W, h)) >= 0.05
    raw = np.where(hit, raw, 0)
    misses = (~hit).sum(-1).astype(np.int32)
    valid = rng.random((R, W)) < 0.9
    tables = (raw, hit, valid & (misses <= 1), misses,
              np.full(num_ids, 2, np.int32), valid)
    out = run_engines(jm, m, tables, num_ids, 10**6)
    assert out["best"][0, 0] > 0


# ---------------------------------------------------------------------------
# MIBFQuerySupport on a filter built by the JAX package
# ---------------------------------------------------------------------------

K, H = 17, 3


def references(seed=5, n=6):
    rng = np.random.default_rng(seed)
    refs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(400, 700))))
            for _ in range(n)]
    refs[2] = refs[1][:200] + refs[2][200:]      # shared stretch: ties
    return refs


def reads_of(refs, seed=9, n=24):
    """Substrings of the references, some with substitutions, and random
    reads."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 6 == 5:
            out.append("".join(rng.choice(list("ACGT"), size=150)))
            continue
        ref = refs[i % len(refs)]
        start = int(rng.integers(0, len(ref) - 150))
        s = list(ref[start: start + 150])
        for j in rng.integers(0, 150, size=i % 4):
            s[j] = "ACGT"[(("ACGT".index(s[j])) + 1) % 4]
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def built():
    """A JAX-built width-2 filter over the references, its port copy, and
    the reads' frames hashed by both sides."""
    refs = references()
    codes = [jax_tables.encode_seq(s) for s in refs]
    pipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=sum(map(len, refs)), k=K, hash_num=H,
        occupancy=0.5))
    for c in codes:
        pipe.insert_bv_seq(c)
    pipe.freeze(2)
    ids = list(range(1, len(refs) + 1))
    pipe.insert_mibf_batch(codes, ids)
    pipe.insert_saturation_batch(codes, ids)
    jm = pipe.m
    reads = [jax_tables.encode_seq(s) for s in reads_of(refs)]
    jfr = jax_api.HashPipeline(K, H).frames_batch(reads)
    fr = api.HashPipeline(K, H, device="cpu").frames_batch(reads)
    return jm, carry(jm), len(refs) + 1, jfr, fr


def result_fields(res):
    return [[dataclasses.astuple(r) for r in rs] for rs in res]


JAX_ENGINES = {}


def jax_engine(jm, max_miss, **kw):
    """One JAX query engine per max_miss, so its compiled graph is reused
    (best_hit_agree and the frame probabilities only enter the host-side
    ranking)."""
    jqs = JAX_ENGINES.setdefault(max_miss, jax_query.MIBFQuerySupport(
        m=jm, max_miss=max_miss, **kw))
    for name, value in kw.items():
        setattr(jqs, name, value)
    return jqs


@pytest.mark.parametrize("max_miss", [0, 1])
@pytest.mark.parametrize("best_hit_agree", [False, True])
def test_query_many_matches_jax(built, max_miss, best_hit_agree):
    jm, m, num_ids, jfr, fr = built
    pfp, _ = jax_mibf.calc_frame_probs(jm, num_ids, max_miss)
    assert pfp == mibf.calc_frame_probs(m, num_ids, max_miss)[0]
    kw = dict(per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=10**6,
              min_count=1, best_hit_agree=best_hit_agree)
    jqs = jax_engine(jm, max_miss, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, max_miss=max_miss, **kw)
    mc = np.full(num_ids, 2, np.int32)
    jres = jqs.query_many(jfr.hashes, np.asarray(jfr.valid), mc)
    res = qs.query_many(fr.hashes, fr.valid, mc)
    assert result_fields(res) == result_fields(jres)
    assert (qs.sat_count, qs.eval_count) == (jqs.sat_count, jqs.eval_count)
    assert sum(1 for r in res if r) >= len(res) // 2
    # one read at a time
    tables = mibf_query.query_device_batch(m, fr.hashes, fr.valid, mc,
                                           max_miss, num_ids, 10**6)
    for r in (0, 7):
        one = qs.query(fr.hashes[r], fr.valid[r], mc)
        assert result_fields([one]) == result_fields([jres[r]])
        single = mibf_query.query_device(m, fr.hashes[r], fr.valid[r], mc,
                                         max_miss, num_ids, 10**6)
        for k in ENGINE_KEYS:
            assert torch.equal(single[k], tables[k][r])


def test_query_early_exit_matches_jax(built):
    jm, m, num_ids, jfr, fr = built
    pfp = [0.0] + [0.1] * (num_ids - 1)
    kw = dict(per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=3,
              max_miss=0, min_count=1, best_hit_agree=False)
    jqs = jax_query.MIBFQuerySupport(m=jm, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, **kw)
    mc = np.full(num_ids, 1, np.int32)
    jres = jqs.query_many(jfr.hashes, np.asarray(jfr.valid), mc)
    res = qs.query_many(fr.hashes, fr.valid, mc)
    assert result_fields(res) == result_fields(jres)
    assert (qs.sat_count, qs.eval_count) == (jqs.sat_count, jqs.eval_count)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def write_fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j: j + 60] + "\n")


def test_cli_build_and_classify_match_jax(tmp_path, capsys):
    refs = references(seed=11, n=5)
    reads = reads_of(refs, seed=12, n=12) + ["ACGTACGTAC"]   # one too short
    fa_refs, fa_reads = str(tmp_path / "refs.fa"), str(tmp_path / "reads.fa")
    write_fasta(fa_refs, [(f"ref{i} sample", s) for i, s in enumerate(refs)])
    write_fasta(fa_reads, [(f"read{i}", s) for i, s in enumerate(reads)])
    out = str(tmp_path / "port.mibf")
    build_mibf.main(["-f", fa_refs, "-k", str(K), "-g", str(H), "-o", out,
                     "--device", "cpu"])
    classify.main(["-f", fa_reads, "-b", out, "-m", "2", "--batch", "5",
                   "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    lines = lines[lines.index(f"wrote {out} (+.sdsl, +.ids)") + 1:]

    # the JAX package in-process, as tools/build_mibf.py and
    # tools/classify.py drive it
    codes = [jax_tables.encode_seq(s) for s in refs]
    pipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=sum(map(len, refs)), k=K, hash_num=H,
        occupancy=0.5))
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
            f.write(f"{i}\tref{i - 1} sample\n")
    for ext in ("", ".sdsl", ".ids"):
        with open(out + ext, "rb") as a, open(ref + ext, "rb") as b:
            assert a.read() == b.read(), ext

    num_ids = len(refs) + 1
    pfp, _ = jax_mibf.calc_frame_probs(pipe.m, num_ids, 0)
    jqs = jax_query.MIBFQuerySupport(
        m=pipe.m, per_frame_prob=pfp, extra_count=2.0,
        extra_frame_limit=10**6, max_miss=0, min_count=1,
        best_hit_agree=False)
    mc = np.full(num_ids, 2, np.int32)
    hp = jax_api.HashPipeline(K, H)
    expect = []
    for i, s in enumerate(reads):
        if len(s) < K:
            expect.append(f"read{i}\t*\tshort")
            continue
        fr = hp.frames_batch([jax_tables.encode_seq(s)])
        res = jqs.query_many(fr.hashes, np.asarray(fr.valid), mc)[0]
        if not res:
            expect.append(f"read{i}\t*\tunclassified")
        else:
            r = res[0]
            expect.append(f"read{i}\t{r.id}\tref{r.id - 1} sample"
                          f"\tnsf={r.non_sat_frame_count}\tcount={r.count}"
                          f"\tsolid={r.solid_count}\tprob={r.frame_prob:.3g}")
    # batches of 5 reads; the short read is reported as it streams by,
    # before the last batch
    assert lines == expect[:10] + expect[12:] + expect[10:12]
    assert sum("unclassified" not in x and "short" not in x
               for x in lines) >= 8


@pytest.mark.parametrize("lengths, budget, expect", [
    ([10] * 5, 64, [(0, 5)]),
    ([10] * 5, 25, [(0, 2), (2, 4), (4, 5)]),
    ([3, 40, 2, 2], 40, [(0, 1), (1, 2), (2, 4)]),
    ([50, 1, 1], 40, [(0, 1), (1, 3)]),
    ([], 40, []),
])
def test_cli_batches_bound_padded_bases(monkeypatch, lengths, budget, expect):
    monkeypatch.setattr(build_mibf, "BATCH_BASES", budget)
    assert list(build_mibf.batches(lengths)) == expect


def test_cli_build_batching_changes_nothing(tmp_path, monkeypatch):
    """Phases 3 and 4 keep stream order across batches: one record per
    batch writes the bytes of one batch of all records."""
    refs = references(seed=13, n=4)
    fa = str(tmp_path / "refs.fa")
    write_fasta(fa, [(f"ref{i}", s) for i, s in enumerate(refs)])
    one, many = str(tmp_path / "one.mibf"), str(tmp_path / "many.mibf")
    flags = ["-f", fa, "-k", str(K), "-g", str(H), "--device", "cpu"]
    build_mibf.main(flags + ["-o", one])
    monkeypatch.setattr(build_mibf, "BATCH_BASES", max(map(len, refs)))
    assert len(list(build_mibf.batches(list(map(len, refs))))) == len(refs)
    build_mibf.main(flags + ["-o", many])
    for ext in ("", ".sdsl"):
        with open(one + ext, "rb") as a, open(many + ext, "rb") as b:
            assert a.read() == b.read(), ext


# ---------------------------------------------------------------------------
# paired-end reads and match signatures
# ---------------------------------------------------------------------------

SEEDS = ("1101111011111", "1111101111011")


@pytest.fixture(scope="module")
def seeded():
    """A JAX-built spaced-seed filter (two mirrored seeds, m2 = 2), its port
    copy, and mutated reads of its references hashed by both sides."""
    refs = references(seed=15, n=5)
    codes = [jax_tables.encode_seq(s) for s in refs]
    k = len(SEEDS[0])
    pipe = jax_api.MIBFConstructPipeline(jax_construct.create(
        expected_entries=sum(map(len, refs)), k=k, hash_num=4,
        occupancy=0.5, spaced_seeds=SEEDS))
    for c in codes:
        pipe.insert_bv_seq(c)
    pipe.freeze(2)
    ids = list(range(1, len(refs) + 1))
    pipe.insert_mibf_batch(codes, ids)
    pipe.insert_saturation_batch(codes, ids)
    jm = pipe.m
    m = mibf.from_numpy(np.asarray(jm.bv_words), np.asarray(jm.data),
                        size=jm.size, hash_num=jm.hash_num, kmer_size=k,
                        data_width=2, sseeds=SEEDS, device="cpu")
    reads = [jax_tables.encode_seq(s) for s in reads_of(refs, seed=16)]
    jfr = jax_api.HashPipeline(k, 4, SEEDS).frames_batch(reads)
    fr = api.HashPipeline(k, 4, SEEDS, device="cpu").frames_batch(reads)
    return jm, m, len(refs) + 1, jfr, fr


def halves(jfr, fr, cut):
    """Mates of 12 pairs on both sides: reads 0-11 whole and reads 12-23
    cut to their first ``cut`` windows (another window count), one mate of
    pair 3 without a valid frame."""
    jv2 = np.asarray(jfr.valid[12:, :cut]).copy()
    v2 = fr.valid[12:, :cut].clone()
    jv2[3] = v2[3] = False
    hi, lo = jfr.hashes.hi, jfr.hashes.lo
    return ((U64(hi[:12], lo[:12]), np.asarray(jfr.valid[:12]),
             U64(hi[12:, :cut], lo[12:, :cut]), jv2),
            (fr.hashes[:12], fr.valid[:12], fr.hashes[12:, :cut], v2))


@pytest.mark.parametrize("which,max_miss", [("built", 0), ("seeded", 1)])
def test_query_paired_matches_jax(built, seeded, which, max_miss):
    jm, m, num_ids, jfr, fr = built if which == "built" else seeded
    pfp = [0.0] + [0.1] * (num_ids - 1)
    kw = dict(per_frame_prob=pfp, extra_count=2.0, extra_frame_limit=10**6,
              max_miss=max_miss, min_count=1, best_hit_agree=False)
    jqs = jax_query.MIBFQuerySupport(m=jm, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, **kw)
    mc = np.full(num_ids, 2, np.int32)
    j, p = halves(jfr, fr, 90)
    jres = jqs.query_paired_many(*j, mc)
    res = qs.query_paired_many(*p, mc)
    assert result_fields(res) == result_fields(jres)
    assert (qs.sat_count, qs.eval_count) == (jqs.sat_count, jqs.eval_count)
    assert sum(1 for r in res if r) >= 6
    one = qs.query_paired(p[0][5], p[1][5], p[2][5], p[3][5], mc)
    assert result_fields([one]) == result_fields([jres[5]])


def test_interleave_paired_frames_matches_jax():
    """The closed-form interleave on frame tables whose reads have more,
    fewer, equal and no valid frames."""
    rng = np.random.default_rng(8)
    R, W1, W2, h = 6, 9, 5, 3

    def tables(W):
        raw = rng.integers(0, 50, size=(R, W, h)).astype(np.uint32)
        hit = rng.random((R, W, h)) < 0.8
        usable = rng.random((R, W)) < 0.7
        misses = (~hit).sum(-1).astype(np.int32)
        return raw, hit, usable, misses

    t1, t2 = tables(W1), tables(W2)
    v1, v2 = rng.random((R, W1)) < 0.6, rng.random((R, W2)) < 0.6
    v1[0], v2[1], v1[2], v2[2] = False, False, False, False
    v2[3] = True
    got = mibf_query.interleave_paired_frames(
        tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                               else a) for a in t1),
        tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                               else a) for a in t2),
        torch.from_numpy(v1), torch.from_numpy(v2))
    ref = jax.jit(jax_query.interleave_paired_frames)(
        tuple(jnp.asarray(a) for a in t1), tuple(jnp.asarray(a) for a in t2),
        jnp.asarray(v1), jnp.asarray(v2))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("which,max_miss", [("built", 0), ("built", 1),
                                            ("seeded", 1), ("seeded", 2)])
def test_match_signature_matches_jax(built, seeded, which, max_miss):
    """A frame matches with every slot hit on a plain k-mer filter
    (max_miss is then not read) and within max_miss on a seeded one."""
    jm, m, num_ids, jfr, fr = built if which == "built" else seeded
    kw = dict(per_frame_prob=[0.0] * num_ids, extra_count=2.0,
              extra_frame_limit=10**6, max_miss=max_miss, min_count=1,
              best_hit_agree=False)
    jqs = jax_query.MIBFQuerySupport(m=jm, **kw)
    qs = mibf_query.MIBFQuerySupport(m=m, **kw)
    for r in (0, 3, 5):
        got = qs.get_match_signature(fr.hashes[r], fr.valid[r])
        ref = jqs.get_match_signature(
            U64(jfr.hashes.hi[r], jfr.hashes.lo[r]), jfr.valid[r])
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
        for a, b in zip(got[2:], ref[2:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        if r != 5:
            assert len(got[0]) > 0
