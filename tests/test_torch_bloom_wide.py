"""The port's classic Bloom filter past 2**32 bits (plain PyTorch path, wide
int64 positions with the sentinel -1) against the JAX package, bit for bit:
the widened modulo, the ntHash positions mode, filter words after insert,
query hits, insert_and_check found flags, the k-mer wrappers and the .bf
bytes, at 2**32, 2**32 + 1000 and 2**33 + 8000 bits (the high limb of a
position reaches 2). Then the wide and the narrow forms of the plain insert,
partition and gather against each other, and the 2**36-bit ceiling.

Inputs are made with numpy from fixed seeds and handed to both sides; all
compared outputs are integers or bools, so the tolerance is zero. The
filters hold 0.5-1 GiB each, so the jitted JAX functions run few times.
"""

import filecmp
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.io import bf_format as jax_bf_format
from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu.models import kmer_bloom as jax_kmer_bloom
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.io import bf_format
from btl_bloomfilter_tpu_torch.kernels import (gather_words, nthash_scan,
                                               scatter_or, tile_partition)
from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
from btl_bloomfilter_tpu_torch.ops import u64
from btl_bloomfilter_tpu_torch.tools import test_bloom, write_bloom

torch.set_num_threads(1)

jax_insert = jax.jit(jax_bloom.insert)
jax_contains = jax.jit(jax_bloom.contains)
jax_insert_and_check = jax.jit(jax_bloom.insert_and_check)
jax_insert_and_check_seq = jax.jit(jax_bloom.insert_and_check_sequential)
jax_insert_seq = jax.jit(jax_kmer_bloom.insert_seq)
jax_contains_seq = jax.jit(jax_kmer_bloom.contains_seq)

SIZES = [1 << 32, (1 << 32) + 1000, (1 << 33) + 8000]
# write_bloom's sizing for a 3.1e9-byte FASTA at -p 0.0001 (h = 13)
GENOME_BITS = 59_427_361_984
LAST32 = 0xFFFFFFFF


def hash_stream(size, h, seed, n=(6, 35)):
    """Hashes uint64 [*n, h] and valid [*n] with in-batch duplicates,
    invalid frames, and slots whose position is 0xFFFFFFFF (the last
    position of a 2**32-bit filter) or size - 1."""
    rng = np.random.default_rng(seed)
    hashes = rng.integers(0, 1 << 64, size=n + (h,), dtype=np.uint64)
    hashes[0, 0, :] = LAST32                    # every slot 0xFFFFFFFF
    hashes[1, 2, 1] = 0xABCDEF01_FFFFFFFF       # one slot, high bits set
    hashes[2, 3, :] = size - 1
    hashes[2, 20] = hashes[0, 3]                # a duplicate in a later row
    hashes[4, 10] = hashes[4, 11] = hashes[5, 2]
    valid = rng.random(n) < 0.8
    valid[0, 0] = valid[1, 2] = valid[2, 3] = True
    valid[4, 10], valid[4, 11] = False, True    # an invalid copy first
    return hashes, valid


def read_codes(seed, rows=3, length=200):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(rows, length), dtype=np.uint8)
    codes[rng.random((rows, length)) < 0.02] = 4
    return codes


def words_equal(bf, jbf, chunk=1 << 24):
    """The two filters' words equal, compared a chunk at a time (a whole
    comparison of 2**28 words through numpy.testing takes seconds)."""
    got, want = bloom.to_numpy_words(bf), np.asarray(jbf.words)
    assert got.shape == want.shape
    for i in range(0, got.size, chunk):
        a, b = got[i:i + chunk], want[i:i + chunk]
        if not np.array_equal(a, b):
            bad = i + np.flatnonzero(a != b)[:5]
            raise AssertionError(f"words differ at {bad.tolist()}: "
                                 f"{got[bad]} != {want[bad]}")


@pytest.mark.parametrize("m", [(1 << 32) - 1, 1 << 32, (1 << 32) + 1000,
                               (1 << 33) + 8000, GENOME_BITS, 1 << 36,
                               (1 << 47) - 1])
def test_mod_const_wide(m):
    rng = np.random.default_rng(m % 1009)
    vals = [int(v) for v in rng.integers(0, 1 << 64, size=2000,
                                         dtype=np.uint64)]
    vals += [0, 1, m - 1, m, m + 1, 2 * m - 1, (1 << 64) - 1, 1 << 63,
             LAST32, ((1 << 64) - 1) // m * m, ((1 << 64) - 1) // m * m - 1]
    got = u64.to_numpy(u64.mod_const(u64.from_numpy(vals), m))
    np.testing.assert_array_equal(got, np.array([v % m for v in vals],
                                                dtype=np.uint64))
    with pytest.raises(ValueError):
        u64.mod_const(u64.from_numpy(vals), 1 << 47)


@functools.lru_cache(maxsize=None)
def jax_frames(seed, k, h):
    """(hashes uint64 [B, W, h], valid [B, W]) of read_codes(seed) by the
    JAX package's hash."""
    f = jax.jit(functools.partial(jax_nthash.hash_frames, k=k, h=h))(
        jnp.asarray(read_codes(seed)))
    return f.hashes.astype_numpy(), np.asarray(f.valid)


@pytest.mark.parametrize("size", [(1 << 32) - 64, 1 << 32,
                                  (1 << 33) + 8000, GENOME_BITS, 1 << 36])
@pytest.mark.parametrize("h", [4, 13])
def test_positions_planes_match_jax_hashes(size, h):
    """The ntHash positions mode (plain) against the JAX hashes mod size:
    the narrow form just below 2**32, the wide one from 2**32 on."""
    hashes, valid = jax_frames(5, 31, h)
    want = np.where(valid[..., None], hashes % np.uint64(size),
                    np.uint64((1 << 64) - 1)).view(np.int64)
    pos, _strand, got_valid = nthash_scan.positions_planes(
        torch.from_numpy(read_codes(5)), 31, h, size)
    assert pos.dtype == bloom.position_dtype(size)
    np.testing.assert_array_equal(got_valid.numpy(), valid)
    got = u64.positions64(pos).movedim(0, -1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES)
def test_insert_contains_and_check_match_jax(size):
    """insert with a mask, contains of the inserted and of fresh frames,
    then insert_and_check of a batch that repeats half of the first: words,
    hits and found flags bit for bit."""
    h = 3
    hashes, valid = hash_stream(size, h, size % 97)
    fresh = np.random.default_rng(1).integers(0, 1 << 64, size=(2, 35, h),
                                              dtype=np.uint64)
    query = np.concatenate([hashes, fresh])
    jbf = jax_insert(jax_bloom.create(size, h, 11), jax_u64.from_numpy(hashes),
                     jnp.asarray(valid))
    bf = bloom.insert(bloom.create(size, h, 11, device="cpu"),
                      u64.from_numpy(hashes), torch.from_numpy(valid))
    words_equal(bf, jbf)
    hit = bloom.contains(bf, u64.from_numpy(query))
    np.testing.assert_array_equal(
        hit.numpy(), np.asarray(jax_contains(jbf, jax_u64.from_numpy(query))))
    assert hit[:6].numpy()[valid].all()
    if size == 1 << 32:       # position 0xFFFFFFFF: the last bit of the filter
        assert int(bf.words[-1]) == -(1 << 31) and bool(hit[0, 0])

    again, v2 = hash_stream(size, h, size % 89)
    again[:3] = hashes[:3]
    jbf, jfound = jax_insert_and_check(jbf, jax_u64.from_numpy(again),
                                       jnp.asarray(v2))
    got, found = bloom.insert_and_check(bf, u64.from_numpy(again),
                                        torch.from_numpy(v2))
    assert got is bf
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    words_equal(bf, jbf)


def test_insert_and_check_sequential_at_2_32():
    """Order-exact insertAndCheck at 2**32 bits, where position 0xFFFFFFFF
    is real: two calls, found and words bit for bit; a later duplicate of a
    valid frame is found. Past 2**32 bits it raises, as the JAX package
    does."""
    size, h = 1 << 32, 4
    hashes, valid = hash_stream(size, h, 3)
    hashes[3, 7] = hashes[0, 0]               # 0xFFFFFFFF again, later
    valid[3, 7] = True
    jbf = jax_bloom.create(size, h, 11)
    bf = bloom.create(size, h, 11, device="cpu")
    for batch, v in ((hashes[:3], valid[:3]), (hashes, valid)):
        jbf, jfound = jax_insert_and_check_seq(
            jbf, jax_u64.from_numpy(batch), jnp.asarray(v))
        _, found = bloom.insert_and_check_sequential(
            bf, u64.from_numpy(batch), torch.from_numpy(v))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        words_equal(bf, jbf)
    assert found[3, 7] and found[2, 20] and found[5, 2]
    del bf, jbf
    past = bloom.BloomFilter(words=torch.zeros(1, dtype=torch.int32),
                             size=(1 << 32) + 64, hash_num=h, kmer_size=11)
    with pytest.raises(NotImplementedError):
        bloom.insert_and_check_sequential(past, u64.from_numpy(hashes))


@pytest.mark.parametrize("size,h", [(1 << 32, 4), ((1 << 32) + 1000, 13),
                                    ((1 << 33) + 8000, 4),
                                    ((1 << 33) + 8000, 13)])
def test_kmer_bloom_matches_jax(size, h):
    """insert_seq of short reads with Ns at k=31, then contains_seq of the
    same reads and of fresh ones: words, hits and valid bit for bit."""
    codes = read_codes(size % 91)
    query = np.concatenate([codes, read_codes(size % 91 + 1)])
    jbf = jax_insert_seq(jax_bloom.create(size, h, 31), jnp.asarray(codes))
    bf = kmer_bloom.insert_seq(bloom.create(size, h, 31, device="cpu"), codes)
    words_equal(bf, jbf)
    jhit, jvalid = jax_contains_seq(jbf, jnp.asarray(query))
    hit, valid = kmer_bloom.contains_seq(bf, query)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert torch.equal(hit[:3], valid[:3])


def test_bf_bytes_match_jax(tmp_path):
    """The .bf file of a filter of 2**32 + 1000 bits (not a multiple of 32:
    the body is cut to size // 8 bytes) equals the JAX package's byte for
    byte, and loads back to the same words."""
    size, h = (1 << 32) + 1000, 4
    hashes, valid = hash_stream(size, h, 7)
    jbf = jax_insert(jax_bloom.create(size, h, 31, dfpr=0.001, n_entry=7,
                                      t_entry=9),
                     jax_u64.from_numpy(hashes), jnp.asarray(valid))
    bf = bloom.insert(bloom.create(size, h, 31, dfpr=0.001, n_entry=7,
                                   t_entry=9, device="cpu"),
                      u64.from_numpy(hashes), torch.from_numpy(valid))
    ours, theirs = tmp_path / "port.bf", tmp_path / "jax.bf"
    bf_format.store_bloom(bf, str(ours))
    jax_bf_format.store_bloom(jbf, str(theirs))
    del jbf
    assert filecmp.cmp(ours, theirs, shallow=False)
    theirs.unlink()
    back = bf_format.load_bloom(str(ours), device="cpu")
    assert (back.size, back.hash_num, back.kmer_size, back.n_entry,
            back.t_entry, back.dfpr) == (size, h, 31, 7, 9, 0.001)
    assert torch.equal(back.words, bf.words)


def test_clis_past_2_32(tmp_path, monkeypatch, capsys):
    """write_bloom then test_bloom through a filter of 2**32 + 64 bits:
    every k-mer of the file is found. write_bloom sizes the filter from the
    file (2**32 bits take a FASTA of about 224 MB), so its sizing is
    replaced here."""
    rng = np.random.default_rng(8)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as f:
        for i in range(6):
            seq = "".join(rng.choice(list("ACGTN"), p=[0.245] * 4 + [0.02],
                                     size=int(rng.integers(100, 400))))
            f.write(f">r{i}\n{seq}\n")
    out = tmp_path / "reads.bf"
    monkeypatch.setattr(write_bloom, "filter_specs",
                        lambda n, fpr: ((1 << 32) + 64, 13))
    write_bloom.main(["-f", str(fa), "-k", "31", "-o", str(out),
                      "--device", "cpu"])
    test_bloom.main(["-f", str(fa), "-b", str(out), "--device", "cpu"])
    found = re.search(r"Found (\d+) out of (\d+)", capsys.readouterr().err)
    assert found and found.group(1) == found.group(2) != "0"
    assert out.stat().st_size > ((1 << 32) + 64) // 8


def narrow_and_wide(size, shape, seed):
    """The same positions (some past the filter, whole windows and stray
    slots set to the sentinel) in the narrow form (int32, 0xFFFFFFFF) and
    the wide form (int64, -1)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, size + 200, size=shape, dtype=np.uint64)
    pos[:, rng.random(shape[1:]) < 0.1] = LAST32
    pos[rng.random(shape) < 0.02] = LAST32
    narrow = torch.from_numpy(pos.astype(np.uint32).view(np.int32))
    wide = torch.from_numpy(np.where(pos == LAST32, -1,
                                     pos.astype(np.int64)))
    return narrow, wide


@pytest.mark.parametrize("size", [1000, (1 << 14) + 8, 1 << 20,
                                  (1 << 24) + 64])
def test_wide_and_narrow_forms_agree(size):
    """The plain insert, tile partition and gather take either form and
    give the same result on the same positions."""
    narrow, wide = narrow_and_wide(size, (4, 3, 700), size % 13)
    nwords = (size + 31) // 32
    start = torch.from_numpy(np.random.default_rng(size).integers(
        0, 1 << 32, size=nwords, dtype=np.uint64).astype(np.uint32)
        .view(np.int32)) & 0x01010101
    a = scatter_or.scatter_or_plain(start.clone(), narrow)
    b = scatter_or.scatter_or_plain(start.clone(), wide)
    assert torch.equal(a, b) and not torch.equal(a, start)
    for tile_shift in (1, 5, 9, tile_partition.TILE_SHIFT):
        if (tile_partition.ntiles(nwords, tile_shift)
                > tile_partition.MAX_TILES):
            continue
        pa = tile_partition.tile_partition_plain(narrow, nwords, 5,
                                                 tile_shift)
        pb = tile_partition.tile_partition_plain(wide, nwords, 5, tile_shift)
        assert torch.equal(pa[0], pb[0]) and torch.equal(pa[1], pb[1])
    qa = gather_words.gather_words_plain(a, narrow)
    qb = gather_words.gather_words_plain(a, wide)
    assert torch.equal(qa, qb) and bool(qa.any())


def test_wide_partition_keeps_low_bits():
    """Wide positions past 2**32 group by tile like any others, and grouped
    holds their low 32 bits, from which the tile gives them back."""
    nwords = (1 << 29) + 40                       # 32769 tiles of 2**14
    rng = np.random.default_rng(4)
    pos = rng.integers(0, nwords * 32 + 900, size=5000, dtype=np.int64)
    pos[::17] = -1
    with pytest.raises(ValueError):               # past MAX_TILES
        tile_partition.tile_partition_plain(torch.from_numpy(pos), nwords, 5)
    nwords = 1 << 29
    offsets, grouped = tile_partition.tile_partition_plain(
        torch.from_numpy(pos), nwords, 5)
    live = np.sort(pos[(pos >= 0) & (pos >> 5 < nwords)])
    total = int(offsets[-1])
    assert total == live.size and int(offsets[0]) == 0
    tiles = np.repeat(np.arange(offsets.numel() - 1),
                      np.diff(offsets.numpy()))
    low = grouped[:total].numpy().view(np.uint32).astype(np.int64)
    back = (tiles << (tile_partition.TILE_SHIFT + 5)) | (
        low & ((1 << (tile_partition.TILE_SHIFT + 5)) - 1))
    np.testing.assert_array_equal(np.sort(back), live)
    assert (back >> 32).max() == 3


def test_sizes_past_2_36_raise():
    """The reference's word index is int32 and wraps past 2**36 bits: the
    port takes sizes up to 2**36 and raises ValueError above."""
    too_big = (1 << 36) + 64
    codes = torch.from_numpy(read_codes(0))
    assert nthash_scan.positions_planes(codes, 31, 2,
                                        1 << 36)[0].dtype == torch.int64
    for call in (lambda: bloom.create(too_big, 4, 31, device="cpu"),
                 lambda: bloom.from_numpy_words(np.zeros(1, np.uint32),
                                                too_big, 4, 31,
                                                device="cpu"),
                 lambda: bloom.hash_positions(u64.from_numpy([1]), too_big),
                 lambda: nthash_scan.positions_planes(codes, 31, 2, too_big)):
        with pytest.raises(ValueError, match="2\\*\\*36"):
            call()
