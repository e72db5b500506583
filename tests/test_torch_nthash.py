"""The port's ntHash (plain PyTorch path) against the JAX package, bit for
bit: hash_frames on random batches, the C++-derived golden vectors, and the
positions planes against the JAX kernel run in interpret mode.

Inputs are made with numpy from fixed seeds and handed to both sides; all
outputs are integers or bools, so the tolerance is zero.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.kernels import nthash_scan as jax_nthash_scan
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu_torch.kernels import nthash_scan
from btl_bloomfilter_tpu_torch.ops import nthash, nthash_tables, u64

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def load_jsonl(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def random_codes(B, L, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    return np.where(rng.random((B, L)) < nfrac, np.uint8(4), codes)


def check_frames(codes, k, h):
    ref = jax.jit(functools.partial(jax_nthash.hash_frames, k=k, h=h))(
        jnp.asarray(codes))
    got = nthash.hash_frames(torch.from_numpy(codes), k, h)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.strand.numpy(), np.asarray(ref.strand))
    np.testing.assert_array_equal(u64.to_numpy(got.hashes),
                                  ref.hashes.astype_numpy())


@pytest.mark.parametrize("B,L,k,h,nfrac,seed", [
    (8, 300, 31, 4, 0.1, 0),     # L not a multiple of 128, with Ns
    (8, 256, 31, 4, 0.0, 1),     # L a block multiple
    (16, 130, 5, 3, 0.3, 2),     # tiny k, N-heavy
    (8, 128, 128, 2, 0.0, 3),    # k == 128, W == 1
    (8, 64, 33, 5, 0.05, 4),     # k > 31 rotations
    (8, 200, 2, 1, 0.2, 5),      # minimum k, h == 1 (no derivation)
    (16, 977, 64, 4, 0.02, 6),   # B not a power of two, k == 64
    (4, 300, 1, 2, 0.1, 7),      # k == 1: one base a window
    (4, 400, 129, 3, 0.003, 7),  # k > 128: two pieces of the kernel's tables
    (4, 1200, 1024, 2, 0.0003, 10),  # k past srol's period of 1023
    (4, 1300, 1025, 4, 0.0003, 10),
])
def test_hash_frames_matches_jax(B, L, k, h, nfrac, seed):
    check_frames(random_codes(B, L, nfrac, seed), k, h)


def test_hash_frames_all_n_rows():
    codes = random_codes(8, 300, 0.0, 9)
    codes[3] = 4
    codes[6] = 4
    check_frames(codes, 21, 3)


def test_codes_above_n_hash_as_n():
    """Any code >= 4 is an N: seed 0 and an invalid window."""
    codes = random_codes(4, 90, 0.1, 10)
    wide = np.where(codes == 4, np.uint8(200), codes)
    a = nthash.hash_frames(torch.from_numpy(codes), 11, 3)
    b = nthash.hash_frames(torch.from_numpy(wide), 11, 3)
    assert torch.equal(a.hashes, b.hashes) and torch.equal(a.valid, b.valid)


NTHASH_CASES = load_jsonl("nthash_golden.jsonl")


@pytest.mark.parametrize("case", NTHASH_CASES, ids=[
    f"k{c['k']}h{c['h']}L{len(c['seq'])}" for c in NTHASH_CASES])
def test_nthash_golden(case):
    seq, k, h = case["seq"], case["k"], case["h"]
    golden = {f["pos"]: f["hashes"] for f in case["frames"]}
    if len(seq) < k:
        assert not golden
        with pytest.raises(ValueError):
            nthash.hash_frames(torch.from_numpy(
                nthash_tables.encode_seq(seq)), k, h)
        return
    f = nthash.hash_frames(torch.from_numpy(nthash_tables.encode_seq(seq)),
                           k, h)
    assert set(np.nonzero(f.valid.numpy())[0].tolist()) == set(golden)
    hashes = u64.to_numpy(f.hashes)
    for pos, expect in golden.items():
        np.testing.assert_array_equal(hashes[pos],
                                      np.array(expect, dtype=np.uint64))


@pytest.mark.parametrize("case", load_jsonl("kmer_golden.jsonl"),
                         ids=lambda c: f"k{c['k']}h{c['h']}")
def test_kmer_golden(case):
    f = nthash.hash_kmers(
        torch.from_numpy(nthash_tables.encode_seq(case["kmer"])),
        case["k"], case["h"])
    np.testing.assert_array_equal(u64.to_numpy(f.hashes),
                                  np.array(case["hashes"], dtype=np.uint64))


@pytest.mark.parametrize("size", [1 << 20, 1000, (1 << 32) - 64])
def test_positions_planes_match_jax_kernel(size):
    codes = random_codes(8, 300, 0.05, 13)
    k, h = 31, 4
    ref_pos, ref_strand, ref_valid = jax_nthash_scan.positions_planes_kernel(
        jnp.asarray(codes), k, h, size, interpret=True)
    pos, strand, valid = nthash_scan.positions_planes(
        torch.from_numpy(codes), k, h, size)
    assert pos.dtype == torch.int32 and pos.shape == (h, 8, 300 - k + 1)
    np.testing.assert_array_equal(pos.numpy().view(np.uint32),
                                  np.asarray(ref_pos))
    np.testing.assert_array_equal(strand.numpy(), np.asarray(ref_strand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def test_hash_frames_planes_layout():
    codes = random_codes(4, 100, 0.05, 14)
    planes, strand, valid = nthash_scan.hash_frames_planes(
        torch.from_numpy(codes), 9, 3)
    f = nthash.hash_frames(torch.from_numpy(codes), 9, 3)
    assert torch.equal(planes, f.hashes.movedim(-1, 0))
    assert torch.equal(strand, f.strand) and torch.equal(valid, f.valid)


@pytest.mark.parametrize("m", [1, 3, 1000, 4096, (1 << 31) + 1,
                               (1 << 32) - 64, (1 << 32) - 1])
def test_mod_const_matches_python(m):
    rng = np.random.default_rng(m % 1000)
    vals = np.concatenate([
        rng.integers(0, 1 << 64, size=2000, dtype=np.uint64),
        np.array([0, 1, m - 1, m, (1 << 64) - 1, (1 << 63), (1 << 63) - 1],
                 dtype=np.uint64)])
    got = u64.mod_const(u64.from_numpy(vals), m).numpy()
    np.testing.assert_array_equal(got, [int(v) % m for v in vals])


def test_unsigned_helpers():
    vals = np.array([0, 1, (1 << 63), (1 << 64) - 1, 0x8000_0000_0000_0001,
                     0x7FFF_FFFF_FFFF_FFFF], dtype=np.uint64)
    x = u64.from_numpy(vals)
    for s in (1, 27, 33, 63):
        np.testing.assert_array_equal(u64.to_numpy(u64.shr(x, s)),
                                      vals >> np.uint64(s))
    lt = u64.lt(x[:, None], x[None, :]).numpy()
    np.testing.assert_array_equal(lt, vals[:, None] < vals[None, :])
    c = 0x90B45D39FB6DA1FA
    np.testing.assert_array_equal(
        u64.to_numpy(u64.mul_const(x, c)),
        np.array([(int(v) * c) % (1 << 64) for v in vals], dtype=np.uint64))


def test_positions_reject_size_2_32():
    """The narrow form stops below 2**32 bits: from 2**32 the positions are
    wide (int64, the sentinel -1), and past 2**36 bits the call raises."""
    codes = torch.zeros((2, 50), dtype=torch.uint8)
    codes[1, 10] = 4
    pos, _strand, valid = nthash_scan.positions_planes(codes, 31, 4, 1 << 32)
    assert pos.dtype == torch.int64
    assert torch.equal(pos[0] == -1, ~valid) and bool((pos >= -1).all())
    with pytest.raises(ValueError):
        nthash_scan.positions_planes(codes, 31, 4, (1 << 36) + 8)


def test_cuda_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        nthash_scan.positions_planes(
            torch.zeros((2, 50), dtype=torch.uint8, device="meta"),
            31, 4, 1 << 20)
