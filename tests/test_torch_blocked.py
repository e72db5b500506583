"""The port's blocked Bloom filter (plain PyTorch path) against the JAX
package's ``models/blocked.py``: every case of ``tests/test_blocked.py``,
seeded N-bearing batches over sizes, k and h (rows, hits,
``_block_and_bits``), ``from_numpy_rows``, ``fpr``, the ``.bbf`` bytes, the
size rules, and a filter of exactly 2**32 bits, where a crafted k-mer's bit
2**32 - 1 is held against a numpy oracle (the JAX insert drops that bit as
its uint32 sentinel).

Inputs are made with numpy from fixed seeds; every compared output is an
integer, a bool or bytes, so the tolerance is zero, and ``fpr`` (the same
double arithmetic in the same order on both sides) is compared exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import blocked as jax_blocked
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu.ops import nthash_tables as jax_tables
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.kernels import blocked_bloom
from btl_bloomfilter_tpu_torch.models import blocked
from btl_bloomfilter_tpu_torch.ops import nthash, nthash_tables, u64

from util import golden_long_seq

torch.set_num_threads(1)

# the JAX references jitted (eager JAX is slow on the CPU); the insert
# updates its filter in place (donated), as a copy would cost 512 MiB at
# 2**32 bits
jax_insert = jax.jit(jax_blocked.insert, donate_argnums=0)
jax_contains = jax.jit(jax_blocked.contains)
jax_hash_frames = jax.jit(jax_nthash.hash_frames, static_argnums=(1, 2))


def jax_frames(codes, k, h=1):
    return jax_hash_frames(jnp.asarray(codes), k, h)


def jax_canon(f):
    return jax_u64.U64(f.hashes.hi[..., 0], f.hashes.lo[..., 0])


def port_frames(codes, k, h=1):
    return nthash.hash_frames(torch.from_numpy(np.asarray(codes)), k, h)


def pair(size, h, k):
    return (jax_blocked.create(size, h, k),
            blocked.create(size, h, k, device="cpu"))


def assert_rows(jbf, bf):
    np.testing.assert_array_equal(blocked.to_numpy_rows(bf),
                                  np.asarray(jbf.rows))


# ---------------------------------------------------------------------------
# the cases of tests/test_blocked.py
# ---------------------------------------------------------------------------

def test_insert_contains_roundtrip():
    codes = nthash_tables.encode_seq(golden_long_seq(300))
    jbf, bf = pair(1 << 16, 4, 21)
    jf = jax_frames(codes, 21)
    jbf = jax_insert(jbf, jax_canon(jf), jf.valid)
    blocked.insert_frames(bf, port_frames(codes, 21))
    assert_rows(jbf, bf)
    f = port_frames(codes, 21)
    hits = blocked.contains_frames(bf, f)
    assert hits[f.valid].all()
    np.testing.assert_array_equal(hits.numpy(), np.asarray(
        jax_contains(jbf, jax_canon(jf)) & jf.valid))
    neg = nthash_tables.encode_seq("G" * 80 + "C" * 80)
    hits2 = blocked.contains_frames(bf, port_frames(neg, 21))
    assert not hits2.all()
    jneg = jax_frames(neg, 21)
    np.testing.assert_array_equal(hits2.numpy(), np.asarray(
        jax_contains(jbf, jax_canon(jneg)) & jneg.valid))


def test_bits_within_one_block():
    jbf, bf = pair(1 << 16, 4, 21)
    c = np.array([12345678901234567], dtype=np.uint64)
    jblock, jbits = jax_blocked._block_and_bits(jbf, jax_u64.from_numpy(c))
    block, bits = blocked._block_and_bits(bf, u64.from_numpy(c))
    np.testing.assert_array_equal(block.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert (bits < 512).all()
    blocked.insert(bf, u64.from_numpy(c))
    rows = blocked.to_numpy_rows(bf)
    touched = np.nonzero(rows.any(axis=1))[0]
    assert touched.tolist() == [int(block[0])]   # one block holds them all
    assert_rows(jax_insert(jbf, jax_u64.from_numpy(c)), bf)


def test_contains_word_boundary_bits():
    """The probe must test bits at word boundaries of a hand-built block;
    clearing any one probed bit turns the query negative."""
    jbf, bf = pair(1 << 14, 4, 21)
    c = np.array([987654321987654321], dtype=np.uint64)
    block, bits = blocked._block_and_bits(bf, u64.from_numpy(c))
    b = int(block[0])
    rows = np.zeros((bf.nblocks, 16), np.uint32)
    for bit in bits[0].tolist():
        rows[b, bit >> 5] |= np.uint32(1) << np.uint32(bit & 31)
    for clear in [None] + bits[0].tolist():
        r = rows.copy()
        if clear is not None:
            r[b, clear >> 5] &= ~(np.uint32(1) << np.uint32(clear & 31))
        pbf = blocked.from_numpy_rows(r, bf.size, 4, 21, device="cpu")
        jr = jax_blocked.BlockedBloomFilter(rows=jnp.asarray(r), size=bf.size,
                                            hash_num=4, kmer_size=21)
        got = bool(blocked.contains(pbf, u64.from_numpy(c))[0])
        assert got == (clear is None)
        assert got == bool(np.asarray(jax_blocked.contains(
            jr, jax_u64.from_numpy(c)))[0])


def test_valid_mask():
    codes = nthash_tables.encode_seq("ACGTNNACGTACGTTGCANCGTACG")
    jbf, bf = pair(1 << 14, 3, 9)
    jf = jax_frames(codes, 9, 3)
    jbf = jax_insert(jbf, jax_canon(jf), jf.valid)
    f = port_frames(codes, 9, 3)
    blocked.insert_frames(bf, f)
    assert_rows(jbf, bf)
    # nothing of an invalid window goes in: the valid canon hashes alone
    # give the same rows
    keep = f.hashes[..., 0][f.valid]
    alone = blocked.insert(blocked.create(1 << 14, 3, 9, device="cpu"), keep)
    np.testing.assert_array_equal(blocked.to_numpy_rows(alone),
                                  blocked.to_numpy_rows(bf))


def test_store_load(tmp_path):
    codes = nthash_tables.encode_seq(golden_long_seq(120))
    jbf, bf = pair(1 << 14, 4, 15)
    jf = jax_frames(codes, 15)
    jbf = jax_insert(jbf, jax_canon(jf), jf.valid)
    blocked.insert_frames(bf, port_frames(codes, 15))
    jp, p = str(tmp_path / "j.bbf"), str(tmp_path / "p.bbf")
    jax_blocked.store(jbf, jp)
    blocked.store(bf, p)
    with open(jp, "rb") as a, open(p, "rb") as b:
        assert a.read() == b.read()
    back = blocked.load(jp, device="cpu")
    np.testing.assert_array_equal(blocked.to_numpy_rows(back),
                                  blocked.to_numpy_rows(bf))
    assert (back.size, back.hash_num, back.kmer_size) == (1 << 14, 4, 15)
    assert back.device == torch.device("cpu")


@pytest.mark.parametrize("size,h,n", [(1 << 20, 4, 30000), (1 << 14, 1, 10),
                                      ((1 << 20) + 3 * 512, 7, 123456),
                                      (1 << 32, 3, 10 ** 9)])
def test_fpr_estimate(size, h, n):
    bf = blocked.create(512, h, 21, device="meta")
    bf.size = size
    est = blocked.fpr(bf, n)
    assert est == jax_blocked.fpr(jax_blocked.BlockedBloomFilter(
        rows=None, size=size, hash_num=h, kmer_size=21), n)
    if (size, n) == (1 << 20, 30000):
        assert 0 < est < 0.05


# ---------------------------------------------------------------------------
# seeded batches
# ---------------------------------------------------------------------------

SIZES = [1 << 14, 1 << 16, (1 << 20) + 3 * 512]


@functools.lru_cache(maxsize=None)
def batch(k, seed=0):
    """Reads with about 2% N and some other non-ACGT codes, and both
    sides' canonical hashes and valid flags (the JAX package's and the
    port's ntHash, held equal)."""
    rng = np.random.default_rng(seed + k)
    codes = rng.integers(0, 4, size=(6, 150), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[rng.random(codes.shape) < 0.005] = 9
    jf = jax_frames(codes, k)
    f = port_frames(codes, k)
    canon = f.hashes[..., 0]
    np.testing.assert_array_equal(u64.to_numpy(canon),
                                  jax_canon(jf).astype_numpy())
    np.testing.assert_array_equal(f.valid.numpy(), np.asarray(jf.valid))
    return codes, jf, canon, f.valid


@pytest.mark.parametrize("k,h,size", [
    (9, 1, SIZES[0]), (9, 4, SIZES[1]), (9, 7, SIZES[2]),
    (21, 3, SIZES[0]), (21, 1, SIZES[2]), (21, 7, SIZES[1]),
    (31, 4, SIZES[0]), (31, 3, SIZES[1]), (31, 1, SIZES[1]),
    (31, 4, SIZES[2]), (31, 7, SIZES[0]), (21, 4, SIZES[2])])
def test_seeded_batches_match_jax(k, h, size):
    codes, jf, canon, valid = batch(k)
    jbf, bf = pair(size, h, k)
    jc = jax_canon(jf)
    # the first half of the reads in, every read queried, through the
    # sequence entry points on the port's side
    half = codes.shape[0] // 2
    jbf = jax_insert(jbf, jax_u64.U64(jc.hi[:half], jc.lo[:half]),
                     jf.valid[:half])
    blocked.insert_seq(bf, codes[:half])
    assert_rows(jbf, bf)
    hit, v = blocked.contains_seq(bf, codes)
    jhit = np.asarray(jax_contains(jbf, jc)) & np.asarray(jf.valid)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_array_equal(v.numpy(), valid.numpy())
    assert hit[:half][v[:half]].all()
    # the hash-level entry points and the kernel wrappers' plain versions
    np.testing.assert_array_equal(
        blocked.contains(bf, canon).numpy(), np.asarray(jax_contains(jbf, jc)))
    block, bits = blocked._block_and_bits(bf, canon)
    jblock, jbits = jax_blocked._block_and_bits(jbf, jc)
    np.testing.assert_array_equal(block.numpy(), np.asarray(jblock))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    # from_numpy_rows carries the JAX rows across
    back = blocked.from_numpy_rows(np.asarray(jbf.rows), size, h, k,
                                   device="cpu")
    np.testing.assert_array_equal(blocked.to_numpy_rows(back),
                                  blocked.to_numpy_rows(bf))


def test_size_rules():
    for size in (0, 100, 511, 1000):
        with pytest.raises(ValueError):
            blocked.create(size, 3, 21, device="cpu")
    # past 2**32 bits the JAX insert's block offset wraps: refused
    with pytest.raises(ValueError):
        blocked.create((1 << 32) + 512, 3, 21, device="cpu")
    with pytest.raises(ValueError):
        blocked.from_numpy_rows(np.zeros((3, 16), np.uint32), 512, 3, 21,
                                device="cpu")
    with pytest.raises(ValueError):
        blocked.from_numpy_rows(np.zeros((1, 16), np.uint32),
                                (1 << 32) + 512, 3, 21, device="cpu")
    rows = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        blocked_bloom.insert(rows, torch.zeros(3, dtype=torch.int32), 21, 3)
    with pytest.raises(ValueError):
        blocked_bloom.insert(rows, torch.zeros(3, dtype=torch.int64), 21, 0)


# ---------------------------------------------------------------------------
# exactly 2**32 bits
# ---------------------------------------------------------------------------

def numpy_block_and_bits(canon, nblocks, k, h):
    """Python-int oracle of the block and the in-block bits."""
    km = (k * jax_tables.MULTI_SEED) & ((1 << 64) - 1)
    out = []
    for c in map(int, canon):
        bits = []
        for j in range(1, h + 1):
            v = (c * (j ^ km)) & ((1 << 64) - 1)
            bits.append((v ^ (v >> 27)) & 511)
        out.append((c % nblocks, bits))
    return out


def crafted_last_bit(k, h):
    """A canonical hash whose block is the last and one of whose bits is
    511: the filter's bit 2**32 - 1."""
    rng = np.random.default_rng(7)
    while True:
        c = int(rng.integers(0, 1 << 41)) << 23 | ((1 << 23) - 1)
        (block, bits), = numpy_block_and_bits([c], 1 << 23, k, h)
        if 511 in bits:
            return c


def test_exactly_2_32_bits():
    size, h, k = 1 << 32, 4, 31
    codes, jf, canon, valid = batch(k)
    jbf, bf = pair(size, h, k)
    jbf = jax_insert(jbf, jax_canon(jf), jf.valid)
    blocked.insert_seq(bf, codes)
    rows_j = np.asarray(jbf.rows)
    touched = np.flatnonzero(rows_j.any(axis=1))
    rows = blocked.to_numpy_rows(bf)
    np.testing.assert_array_equal(np.flatnonzero(rows.any(axis=1)), touched)
    np.testing.assert_array_equal(rows[touched], rows_j[touched])
    hit, _ = blocked.contains_seq(bf, codes)
    np.testing.assert_array_equal(
        hit.numpy(), np.asarray(jax_contains(jbf, jax_canon(jf)))
        & np.asarray(jf.valid))
    del jbf, rows_j
    # a crafted k-mer with bit 2**32 - 1: the port sets it, the numpy
    # oracle says so; the JAX insert drops it (its uint32 sentinel)
    c = np.array([crafted_last_bit(k, h)], np.uint64)
    before = rows.copy()[-1]
    blocked.insert(bf, u64.from_numpy(c))
    (block, bits), = numpy_block_and_bits(c, 1 << 23, k, h)
    assert block == (1 << 23) - 1
    want = before.copy()
    for b in bits:
        want[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    np.testing.assert_array_equal(rows[-1], want)
    assert rows[-1, 15] >> 31 == 1
    assert bool(blocked.contains(bf, u64.from_numpy(c))[0])
    assert np.array_equal(np.flatnonzero(rows.any(axis=1)),
                          np.union1d(touched, [block]))
