"""The port's multi-index Bloom filter at exactly 2**32 bits (plain PyTorch
path) against the JAX package: one build through phases 1-4 and
``query_many`` (bit vector, IDs, counters, result lists, ``.mibf`` and
``.sdsl`` bytes), a crafted frame at position 2**32 - 1 against numpy, the
bounds past 2**32 bits and the ``freeze`` refusal at 2**31 set bits. The
JAX package's phase 1 refuses 2**32 bits, so its side of the build starts
from a bit vector numpy set from the same frames. Its ``.sdsl`` writer
would take hours at 2**32 bits (its select-sample BFS pops a list's head,
quadratic in 2**23 superblocks), so there the port's ``.sdsl`` is read
back, and the port's writer is held to the JAX package's bytes at smaller
sizes.

A 2**32-bit vector is 512 MiB. The JAX side is built first and reduced to
small arrays before the port's is built, so a process holds one side at a
time. Inputs come from fixed seeds; every compared output is an integer, a
bool or bytes, so the tolerance is zero.
"""

import dataclasses
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import api as jax_api
from btl_bloomfilter_tpu.io import mibf_format as jax_mibf_format
from btl_bloomfilter_tpu.io import sdsl as jax_sdsl
from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.models import mibf_query as jax_query
from btl_bloomfilter_tpu.ops import nthash_tables as jax_tables
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch import api
from btl_bloomfilter_tpu_torch.io import mibf_format, sdsl
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct, mibf_query
from btl_bloomfilter_tpu_torch.ops import u64

torch.set_num_threads(1)

SIZE = 1 << 32
K, H, WIDTH = 31, 4, 2

# jitted JAX phases that update the filter in place (donated): eager JAX is
# slow on the CPU, and a jitted call without donation copies the filter
jax_insert_mibf_many = jax.jit(jax_construct.insert_mibf_many,
                               donate_argnums=(0, 1))
jax_insert_saturation_many = jax.jit(jax_construct.insert_saturation_many,
                                     donate_argnums=(0, 1))


def references(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list("ACGT"), size=int(rng.integers(90, 140))))
            for _ in range(n)]


def reads_of(refs, seed=4):
    """A stretch of each reference (one with an N), and a random read."""
    rng = np.random.default_rng(seed)
    out = []
    for r in refs:
        start = int(rng.integers(0, len(r) - 60))
        out.append(r[start:start + 60])
    out[1] = out[1][:20] + "N" + out[1][21:]
    out.append("".join(rng.choice(list("ACGT"), size=60)))
    return out


def sparse(words: np.ndarray):
    """(indices, values) of the nonzero words of a bit vector."""
    idx = np.flatnonzero(words)
    return idx, words[idx].copy()


def result_fields(res):
    return [[dataclasses.astuple(r) for r in rs] for rs in res]


def phase1_numpy(refs):
    """The bit vector of phase 1 over the references' frames (hashed by
    the JAX package), set by numpy: positions are the hashes' low limbs."""
    fr = jax_api.HashPipeline(K, H).frames_batch(
        [jax_tables.encode_seq(s) for s in refs])
    pos = np.asarray(fr.hashes.lo)[np.asarray(fr.valid)].reshape(-1)
    words = np.zeros(SIZE // 32, np.uint32)
    np.bitwise_or.at(words, (pos >> 5).astype(np.int64),
                     np.uint32(1) << (pos & 31))
    return words


@pytest.mark.parametrize("nblocks", list(range(0, 40)) + [1023, 1025, 4099])
def test_rank_samples_match_jax(nblocks):
    """The port's level-at-a-time BFS of the ``.sdsl`` select samples
    equals the JAX package's one-interval-at-a-time BFS."""
    br = np.cumsum(np.random.default_rng(nblocks).integers(
        0, 513, nblocks)).astype(np.uint64)
    ref = jax_sdsl._rank_samples(br)
    got = sdsl._rank_samples(br)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size_bits", [1, 64, 511, 512, 513, 4096 + 32,
                                       (1 << 20) + 96])
def test_sdsl_writer_matches_jax(size_bits):
    """The port's vectorised bit_vector_il<512> writer (streamed to the
    file) gives the JAX package's bytes."""
    bits = np.random.default_rng(size_bits).integers(
        0, 1 << 32, (size_bits + 31) // 32, dtype=np.uint32)
    bits[-1] &= np.uint32((1 << (size_bits % 32 or 32)) - 1)
    assert sdsl.serialize_bit_vector_il(bits, size_bits) == \
        jax_sdsl.serialize_bit_vector_il(bits, size_bits)


@pytest.mark.parametrize("size_bits", [512, 1536, 1537, 4096 + 32,
                                       (1 << 16) + 96])
def test_sdsl_writer_in_chunks_matches_jax(size_bits, monkeypatch):
    """The writer's chunk boundaries (three superblocks a chunk here, 2**18
    by default) leave the JAX package's bytes unchanged."""
    monkeypatch.setattr(sdsl, "_POP_BLOCKS", 3)
    bits = np.random.default_rng(size_bits + 1).integers(
        0, 1 << 32, (size_bits + 31) // 32, dtype=np.uint32)
    bits[-1] &= np.uint32((1 << (size_bits % 32 or 32)) - 1)
    assert sdsl.serialize_bit_vector_il(bits, size_bits) == \
        jax_sdsl.serialize_bit_vector_il(bits, size_bits)


def build(side, refs, reads, path, words=None, monkeypatch=None):
    """Phases 1-4 at 2**32 bits on one side, then query_many of the reads;
    returns small arrays only. The JAX package's phase 1 refuses 2**32
    bits (its sentinel-position insert requires fewer), so its side starts
    from the bit vector ``words`` that numpy set; the port runs phase 1
    itself."""
    codes = [jax_tables.encode_seq(s) for s in refs]
    ids = list(range(1, len(refs) + 1))
    rc = [jax_tables.encode_seq(s) for s in reads]
    if side == "jax":
        st = jax_construct.BitVectorState(
            bv_words=jnp.asarray(words), filter_size=SIZE, kmer_size=K,
            hash_num=H, occupancy=0.5, sseeds=())
        hp = jax_api.HashPipeline(K, H)
        fr = hp.frames_batch(codes)
        m, counts = jax_construct.get_empty_mibf(st, WIDTH)
        del st
        m, counts = jax_insert_mibf_many(m, counts, fr.hashes,
                                         jnp.asarray(ids), fr.valid)
        m, counts = jax_insert_saturation_many(m, counts, fr.hashes,
                                               jnp.asarray(ids), fr.valid)
        frames = hp.frames_batch(rc)
        mod, qmod = jax_mibf, jax_query
        valid = np.asarray(frames.valid)
    else:
        pipe = api.MIBFConstructPipeline(mibf_construct.BitVectorState(
            bv_words=torch.zeros(SIZE // 32, dtype=torch.int32),
            filter_size=SIZE, kmer_size=K, hash_num=H, occupancy=0.5,
            sseeds=()))
        for c in codes:
            pipe.insert_bv_seq(c)
        m = pipe.freeze(WIDTH)
        pipe.insert_mibf_batch(codes, ids)
        pipe.insert_saturation_batch(codes, ids)
        counts = pipe.counts
        frames = api.HashPipeline(K, H, device="cpu").frames_batch(rc)
        mod, qmod = mibf, mibf_query
        valid = frames.valid
    num_ids = len(refs) + 1
    pfp, _ = mod.calc_frame_probs(m, num_ids, 0)
    qs = qmod.MIBFQuerySupport(m=m, per_frame_prob=pfp, extra_count=2.0,
                               extra_frame_limit=10**6, max_miss=0,
                               min_count=1, best_hit_agree=False)
    res = qs.query_many(frames.hashes, valid, np.full(num_ids, 2, np.int32))
    if side == "jax":
        # its .sdsl writer walks 2**23 superblocks in a Python loop (40 s
        # and 3 GiB here): the port's .sdsl is read back instead
        monkeypatch.setattr(jax_sdsl, "serialize_bit_vector_il",
                            lambda bits, size: b"")
    (jax_mibf_format if side == "jax" else mibf_format).store_mibf(m, path)
    if side == "jax":
        words = np.asarray(m.bv_words)
        data, counts = np.asarray(m.data), np.asarray(counts)
    else:
        words = m.bv_words.numpy().view(np.uint32)
        data, counts = mibf.to_numpy(m)[2], counts.numpy().view(np.uint16)
    with open(path, "rb") as f:
        main = f.read()
    out = dict(bv=sparse(words), d_size=int(m.d_size), data=data.copy(),
               counts=counts.copy(), results=result_fields(res),
               sat=(qs.sat_count, qs.eval_count), mibf=main)
    if side == "port":
        del m, pipe, words, qs
        gc.collect()
        back = mibf_format.load_mibf(path, WIDTH, device="cpu")
        out["back"] = (sparse(back.bv_words.numpy().view(np.uint32)),
                       mibf.to_numpy(back)[2].copy(), back.size)
    os.remove(path + ".sdsl")
    return out


def test_build_and_query_at_2_32_bits_match_jax(tmp_path, monkeypatch):
    refs = references()
    reads = reads_of(refs)
    words = phase1_numpy(refs)
    ref_bv = sparse(words)
    ref = build("jax", refs, reads, str(tmp_path / "jax.mibf"), words,
                monkeypatch)
    del words
    gc.collect()
    got = build("port", refs, reads, str(tmp_path / "port.mibf"))
    (bv_idx, bv_val), data, size = got["back"]      # the .sdsl read back
    assert size == SIZE
    np.testing.assert_array_equal(data, ref["data"])
    for a, b, c, d in zip(got["bv"], ref["bv"], ref_bv, (bv_idx, bv_val)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, d)
    for key in ("d_size", "results", "sat", "mibf"):
        assert got[key] == ref[key], key
    for key in ("data", "counts"):
        np.testing.assert_array_equal(got[key], ref[key])
    # the build sets bits, assigns IDs and classifies the source reads
    assert ref["d_size"] > 1000 and (ref["data"] != 0).any()
    assert [r[0][0] if r else 0 for r in got["results"]][:len(refs)] == \
        list(range(1, len(refs) + 1))


def test_position_2_32_minus_1_is_counted():
    """A frame whose slot lands on bit 2**32 - 1: the port sets that bit in
    phase 1 (through the wide scatter) and ranks, finds and names it in
    phases 3-4 and lookups, as a numpy mirror says (0xFFFFFFFF is the JAX
    package's phase-1 sentinel)."""
    last = SIZE - 1
    hashes = np.array([[last, last + (7 << 32), 12345, SIZE + 99],
                       [5, 6, 7, 8],
                       [last - 1, 1 << 31, 3, 4]], np.uint64)
    valid = np.array([True, False, True])
    st = mibf_construct.BitVectorState(
        bv_words=torch.zeros(SIZE // 32, dtype=torch.int32),
        filter_size=SIZE, kmer_size=K, hash_num=H, occupancy=0.5, sseeds=())
    mibf_construct.insert_bv(st, u64.from_numpy(hashes),
                             torch.from_numpy(valid))
    pos = np.unique((hashes[valid] % np.uint64(SIZE)).reshape(-1))
    words = np.zeros(SIZE // 32, np.uint32)
    np.bitwise_or.at(words, (pos >> np.uint64(5)).astype(np.int64),
                     np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32))
    got_idx, got_val = sparse(st.bv_words.numpy().view(np.uint32))
    ref_idx, ref_val = sparse(words)
    np.testing.assert_array_equal(got_idx, ref_idx)
    np.testing.assert_array_equal(got_val, ref_val)
    assert got_val[-1] >> 31 == 1                       # bit 2**32 - 1
    del words
    m, counts = mibf_construct.get_empty_mibf(st, WIDTH)
    assert m.d_size == pos.size
    mibf_construct.insert_mibf(m, counts, u64.from_numpy(hashes), 9,
                               torch.from_numpy(valid))
    mibf_construct.insert_saturation(m, counts, u64.from_numpy(hashes), 9,
                                     torch.from_numpy(valid))
    rank, hit, raw = mibf.at_rank_data(m, u64.from_numpy(hashes[:1]))
    # the sorted distinct positions are the ranks: 2**32 - 1 ranks last
    assert rank.tolist() == [[pos.size - 1, pos.size - 1,
                              int(np.searchsorted(pos, 12345)),
                              int(np.searchsorted(pos, 99))]]
    assert hit.all() and (raw == 9).all()
    np.testing.assert_array_equal(mibf.ids_numpy(m), np.full(pos.size, 9))


def test_jax_phase_1_refuses_2_32_bits():
    """The JAX package's mibf.positions takes 2**32 bits, but its phase 1
    refuses them (recorded in ROADMAP.md); the port builds them."""
    st = jax_construct.BitVectorState(
        bv_words=jnp.zeros(SIZE // 32, jnp.uint32), filter_size=SIZE,
        kmer_size=K, hash_num=1, occupancy=0.5, sseeds=())
    one = jax_u64.from_numpy(np.array([[SIZE - 1]], np.uint64))
    for fn in (jax_construct.insert_bv, jax_construct.insert_bv_colli):
        with pytest.raises(ValueError):
            fn(st, one)


def test_sizes_past_2_32_bits_raise():
    st = mibf_construct.BitVectorState(
        bv_words=torch.zeros(1, dtype=torch.int32), filter_size=SIZE + 64,
        kmer_size=K, hash_num=1, occupancy=0.5, sseeds=())
    one = u64.from_numpy(np.zeros((1, 1), np.uint64))
    for fn in (mibf_construct.insert_bv, mibf_construct.insert_bv_colli,
               mibf_construct.insert_bv_colli_sequential):
        with pytest.raises(ValueError):
            fn(st, one)
    m = mibf.freeze(torch.zeros(2, dtype=torch.int32), 64, 1, K)
    with pytest.raises(ValueError):
        mibf.positions(dataclasses.replace(m, size=SIZE + 64), one)
    assert mibf.positions(dataclasses.replace(m, size=SIZE), u64.from_numpy(
        np.array([SIZE - 1], np.uint64))).tolist() == [-1]


def test_freeze_refuses_2_31_set_bits():
    """Ranks stay int32: a vector of 2**31 set bits is refused."""
    words = torch.full((1 << 26,), -1, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        mibf.freeze(words, 1 << 31, 1, K)
