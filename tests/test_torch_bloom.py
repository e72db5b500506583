"""The port's classic Bloom filter (plain PyTorch path) against the JAX
package: filter words after insert and query hits, bit for bit, plus the
word round trip between the two packages, popcount and the sizing math.

Inputs are made with numpy from fixed seeds and handed to both sides; all
compared outputs are integers or bools, so the tolerance is zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu.models import kmer_bloom as jax_kmer_bloom
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
from btl_bloomfilter_tpu_torch.ops import u64

torch.set_num_threads(1)

# jitted JAX references: eager JAX dispatches op by op and is slow on the CPU
jax_insert_seq = jax.jit(jax_kmer_bloom.insert_seq)
jax_contains_seq = jax.jit(jax_kmer_bloom.contains_seq)
jax_insert = jax.jit(jax_bloom.insert)
jax_contains = jax.jit(jax_bloom.contains)

SENT = np.uint32(0xFFFFFFFF)
SIZES = [1000, 1 << 14, 1 << 20]


def random_positions(size, shape, sent_frac, seed):
    """uint32 positions < size; whole windows (axis 0 = h slots) set to the
    sentinel with probability sent_frac."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, size, size=shape, dtype=np.uint64).astype(np.uint32)
    invalid = rng.random(shape[1:]) < sent_frac
    return np.where(invalid[None], SENT, pos)


def port_words(bf):
    return bloom.to_numpy_words(bf)


def as_i32(pos_u32):
    return torch.from_numpy(pos_u32.view(np.int32).copy())


@pytest.mark.parametrize("size", SIZES)
def test_insert_sentinel_positions_matches_jax(size):
    pos = random_positions(size, (4, 16, 300), 0.2, size % 97)
    ref = jax_bloom.insert_sentinel_positions(
        jax_bloom.create(size, 4, 31), jnp.asarray(pos))
    got = bloom.insert_sentinel_positions(bloom.create(size, 4, 31,
                                                       device="cpu"),
                                          as_i32(pos))
    np.testing.assert_array_equal(port_words(got), np.asarray(ref.words))


@pytest.mark.parametrize("size", SIZES)
def test_contains_sentinel_positions_matches_jax(size):
    ins = random_positions(size, (3, 8, 200), 0.1, 1)
    qry = np.concatenate([ins, random_positions(size, (3, 8, 200), 0.1, 2)],
                         axis=1)
    jbf = jax_bloom.insert_sentinel_positions(jax_bloom.create(size, 3, 21),
                                              jnp.asarray(ins))
    ref = jax_bloom.contains_sentinel_positions(jbf, jnp.asarray(qry))
    bf = bloom.insert_sentinel_positions(bloom.create(size, 3, 21,
                                                      device="cpu"),
                                         as_i32(ins))
    got = bloom.contains_sentinel_positions(bf, as_i32(qry))
    assert got.shape == (16, 200)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[:8].numpy()[ins[0] != SENT].all()


@pytest.mark.parametrize("size", SIZES)
def test_insert_contains_hashes_match_jax(size):
    rng = np.random.default_rng(size % 89)
    hashes = rng.integers(0, 1 << 64, size=(40, 25, 4), dtype=np.uint64)
    valid = rng.random((40, 25)) < 0.7
    probe = np.concatenate(
        [hashes[:20], rng.integers(0, 1 << 64, size=(20, 25, 4),
                                   dtype=np.uint64)])
    jbf = jax_insert(jax_bloom.create(size, 4, 11),
                     jax_u64.from_numpy(hashes), jnp.asarray(valid))
    bf = bloom.insert(bloom.create(size, 4, 11,
                                   device="cpu"), u64.from_numpy(hashes),
                      torch.from_numpy(valid))
    np.testing.assert_array_equal(port_words(bf), np.asarray(jbf.words))
    ref = jax_contains(jbf, jax_u64.from_numpy(probe))
    got = bloom.contains(bf, u64.from_numpy(probe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def random_codes(B, L, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    return np.where(rng.random((B, L)) < nfrac, np.uint8(4), codes)


def test_jax_built_filter_queried_and_extended_by_port():
    size, h, k = 1 << 16, 4, 15
    a, b = random_codes(8, 200, 0.05, 3), random_codes(8, 200, 0.05, 4)
    jbf = jax_insert_seq(jax_bloom.create(size, h, k), a)

    bf = bloom.from_numpy_words(np.asarray(jbf.words), size, h, k,
                                device="cpu")
    for codes in (a, b):
        ref_hit, ref_valid = jax_contains_seq(jbf, codes)
        hit, valid = kmer_bloom.contains_seq(bf, codes)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))

    jbf2 = jax_insert_seq(jbf, b)
    kmer_bloom.insert_seq(bf, b)
    np.testing.assert_array_equal(port_words(bf), np.asarray(jbf2.words))


def test_port_built_filter_queried_by_jax():
    size, h, k = 4096, 3, 9
    a = random_codes(4, 120, 0.05, 5)
    bf = kmer_bloom.insert_seq(bloom.create(size, h, k, device="cpu"), a)
    jbf = jax_bloom.BloomFilter(words=jnp.asarray(bloom.to_numpy_words(bf)),
                                size=size, hash_num=h, kmer_size=k)
    ref = jax_insert_seq(jax_bloom.create(size, h, k), a)
    np.testing.assert_array_equal(np.asarray(jbf.words),
                                  np.asarray(ref.words))
    probe = random_codes(4, 120, 0.05, 6)
    ref_hit, _ = jax_contains_seq(jbf, probe)
    hit, _ = kmer_bloom.contains_seq(bf, probe)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))


def test_from_numpy_words_checks_length():
    with pytest.raises(ValueError):
        bloom.from_numpy_words(np.zeros(3, np.uint32), 1024, 3, 5,
                               device="cpu")


def test_get_pop_and_fpr_match_jax():
    pos = random_positions(1 << 14, (4, 8, 100), 0.1, 7)
    jbf = jax_bloom.insert_sentinel_positions(jax_bloom.create(1 << 14, 4, 5),
                                              jnp.asarray(pos))
    bf = bloom.insert_sentinel_positions(bloom.create(1 << 14, 4, 5,
                                                      device="cpu"),
                                         as_i32(pos))
    assert bloom.get_pop(bf) == int(jax_bloom.get_pop(jbf))
    assert bloom.get_pop(bf) == int(np.unpackbits(
        bloom.to_numpy_words(bf).view(np.uint8)).sum())
    assert abs(bloom.get_fpr(bf) - float(jax_bloom.get_fpr(jbf))) < 1e-7
    for num in (0, 10, 1000):
        assert bloom.calc_fpr_num_inserted(bf, num) == \
            jax_bloom.calc_fpr_num_inserted(jbf, num)


@pytest.mark.parametrize("entries,fpr,h", [
    (1000, 0.01, 3), (123456, 0.0001, 0), (10 ** 7, 0.05, 4)])
def test_sizing_math_matches_jax(entries, fpr, h):
    assert bloom.calc_optimal_size(entries, fpr, max(h, 1)) == \
        jax_bloom.calc_optimal_size(entries, fpr, max(h, 1))
    assert bloom.calc_opti_hash_num(fpr) == jax_bloom.calc_opti_hash_num(fpr)
    got = bloom.create_from_fpr(entries, fpr, h, 21, device="cpu")
    ref = jax_bloom.create_from_fpr(entries, fpr, h, 21)
    assert (got.size, got.hash_num, got.dfpr) == (ref.size, ref.hash_num,
                                                   ref.dfpr)
    assert got.words.shape == ref.words.shape


def test_size_rules():
    """Sizes must be multiples of 8; from 2**32 bits positions are wide
    (int64, sentinel -1) and the insert takes them, 0xFFFFFFFF being a real
    position; past 2**36 bits every entry raises ValueError. The filters'
    words are cut to two: positions past them are dropped."""
    with pytest.raises(ValueError):
        bloom.create(1001, 4, 5, device="cpu")
    big = bloom.BloomFilter(words=torch.zeros(2, dtype=torch.int32),
                            size=1 << 32, hash_num=1, kmer_size=5)
    bloom.insert_sentinel_positions(
        big, torch.tensor([0, 33, -1, 0xFFFFFFFF], dtype=torch.int64))
    assert big.words.tolist() == [1, 2]
    with pytest.raises(TypeError):       # the narrow form is ambiguous here
        bloom.insert_sentinel_positions(big, torch.zeros(1, dtype=torch.int32))
    too_big = (1 << 36) + 64
    with pytest.raises(ValueError):
        bloom.create(too_big, 4, 5, device="cpu")
    huge = dataclasses.replace(big, size=too_big)
    for fn in (bloom.insert_sentinel_positions,
               bloom.contains_sentinel_positions):
        with pytest.raises(ValueError):
            fn(huge, torch.zeros((1, 1), dtype=torch.int64))
    with pytest.raises(ValueError):
        bloom.insert(huge, torch.zeros((1, 1), dtype=torch.int64))


jax_insert_and_check = jax.jit(jax_bloom.insert_and_check)
jax_insert_and_check_seq = jax.jit(jax_bloom.insert_and_check_sequential)
INSERT_AND_CHECK = {
    "batched": (jax_insert_and_check, bloom.insert_and_check),
    "sequential": (jax_insert_and_check_seq,
                   bloom.insert_and_check_sequential),
}


def check_stream(size, h, seed):
    """Frames [6, 35, h] with in-batch duplicate frames (in one row and
    across rows), a frame whose slots repeat one hash, invalid frames, and
    invalid copies of later valid frames."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, 1 << 64, size=(6, 35, h), dtype=np.uint64)
    hashes[2, 20] = hashes[0, 3]          # a duplicate in a later row
    hashes[1, 30] = hashes[1, 5]          # a duplicate in the same row
    hashes[4, 10] = hashes[4, 11] = hashes[5, 2]
    hashes[3, 7, :] = hashes[3, 7, 0]     # one hash in every slot
    hashes[3, 8, 1] = hashes[3, 8, 0]
    valid = rng.random((6, 35)) < 0.8
    valid[4, 10] = False                  # invalid, then valid copies
    valid[4, 11] = valid[5, 2] = True
    valid[0, 3] = valid[2, 20] = valid[1, 5] = valid[1, 30] = True
    return hashes, valid


@pytest.mark.parametrize("form", sorted(INSERT_AND_CHECK))
@pytest.mark.parametrize("size,h,masked", [
    (1000, 3, True), (1 << 14, 4, True), (1 << 16, 2, False),
    (999_992, 5, True)])
def test_insert_and_check_matches_jax(form, size, h, masked):
    """Two calls on one filter, words and found bit for bit; a small filter
    makes found True often before the batch too."""
    jax_fn, port_fn = INSERT_AND_CHECK[form]
    hashes, valid = check_stream(size, h, size % 97 + h)
    jbf = jax_bloom.create(size, h, 11)
    bf = bloom.create(size, h, 11, device="cpu")
    for batch in (hashes[:3], hashes):
        v = valid[: len(batch)] if masked else None
        jbf, jfound = jax_fn(jbf, jax_u64.from_numpy(batch),
                             None if v is None else jnp.asarray(v))
        got, found = port_fn(bf, u64.from_numpy(batch),
                             None if v is None else torch.from_numpy(v))
        assert got is bf and found.shape == batch.shape[:-1]
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(port_words(bf), np.asarray(jbf.words))
    if form == "sequential":
        assert found[2, 20] and found[1, 30] and found[5, 2]
        if masked:
            assert not found[~valid].any()


@pytest.mark.parametrize("form", sorted(INSERT_AND_CHECK))
def test_insert_and_check_twice(form):
    """The two-call case of tests/test_filters.py: a frame is new, then
    found."""
    jax_fn, port_fn = INSERT_AND_CHECK[form]
    hashes = u64.from_numpy(np.array([[1, 2, 3]], dtype=np.uint64))
    jbf = jax_bloom.create(800, 3, 5)
    bf = bloom.create(800, 3, 5, device="cpu")
    for want in (False, True):
        jbf, jfound = jax_fn(jbf, jax_u64.from_numpy(
            np.array([[1, 2, 3]], dtype=np.uint64)), None)
        _, found = port_fn(bf, hashes)
        assert bool(found[0]) == bool(jfound[0]) == want
    np.testing.assert_array_equal(port_words(bf), np.asarray(jbf.words))


def test_insert_and_check_sequential_sees_earlier_frames():
    """A later duplicate of a valid frame reports True, its first copy and
    an invalid copy False; the batched form reports all False. Then an
    invalid frame already in the filter: found by the batched form (not
    masked by valid), not by the sequential one."""
    hashes = np.array([[5, 6], [7, 8], [5, 6], [9, 10], [9, 10]],
                      dtype=np.uint64)
    valid = torch.tensor([True, True, True, False, True])
    for form, want in (("sequential", [False, False, True, False, False]),
                       ("batched", [False] * 5)):
        fn = INSERT_AND_CHECK[form][1]
        bf = bloom.create(1 << 12, 2, 5, device="cpu")
        _, found = fn(bf, u64.from_numpy(hashes), valid)
        assert found.tolist() == want
        _, found = fn(bf, u64.from_numpy(hashes[:1]), torch.tensor([False]))
        assert found.tolist() == [form == "batched"]
