"""The host-side pieces of the ntHash kernel's roll (``csrc/nthash_scan.cu``)
on the CPU: the per-k roll tables against ``srol_pow`` of the port and of
the JAX package, the kernel's one-step split rotations, a numpy model of
the kernel's runs (roll-in from the all-N window, then R - 1 roll steps)
against the JAX package's ``strand_hashes``, and the cached Barrett pair.

The card tests (``tests/test_torch_cuda_kernels.py``) hold the kernel
itself against the plain path. Inputs are made with numpy from fixed seeds;
every output is an integer or a bool, so the tolerance is zero.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.kernels import _build, nthash_scan
from btl_bloomfilter_tpu_torch.ops import nthash, nthash_tables as T, u64

torch.set_num_threads(1)

K_VALUES = [1, 2, 31, 32, 33, 63, 64, 128, 129, 1023, 1024, 1025]
M = np.uint64


def tables(k):
    t = np.frombuffer(bytes(nthash_scan.roll_tables(k)), dtype=np.uint64)
    return t[:25].reshape(5, 5), t[25:].reshape(5, 5)


def srol_pow_port(v: np.ndarray, t: int) -> np.ndarray:
    return u64.to_numpy(nthash.srol_pow(u64.from_numpy(v), t % 33, t % 31))


def srol_pow_jax(v: np.ndarray, t: int) -> np.ndarray:
    return jax_nthash.srol_pow_static(jax_u64.from_numpy(v), t).astype_numpy()


@pytest.mark.parametrize("k", K_VALUES)
def test_roll_tables_match_srol_pow(k):
    f, r = tables(k)
    seeds, rc = T.SEEDS, T.RC_SEEDS
    for srol in (srol_pow_port, srol_pow_jax):
        # f[out, in] = srol^k(seed(out)) ^ seed(in)
        np.testing.assert_array_equal(
            f, srol(seeds, k)[:, None] ^ seeds[None, :])
        # r[out, in] = sror(rcseed(out)) ^ srol^(k-1)(rcseed(in))
        np.testing.assert_array_equal(
            r, srol(rc, -1)[:, None] ^ srol(rc, k - 1)[None, :])
    # N's seed is 0: the roll-in row (out = N) is the plain seeds
    np.testing.assert_array_equal(f[T.CODE_N], seeds)
    assert nthash_scan.roll_tables(k) is nthash_scan.roll_tables(k)


# the kernel's one-step rotations (srol1 / sror1 in csrc/nthash_roll.cuh)
def srol1(v):
    return (((v << M(1)) & ~M(1 << 33)) | ((v >> M(32)) & M(1))
            | ((v >> M(30)) & M(1 << 33)))


def sror1(v):
    return (((v >> M(1)) & ~M(1 << 32)) | ((v & M(1)) << M(32))
            | ((v & M(1 << 33)) << M(30)))


def test_split_rotation_steps_match_srol_pow():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.integers(0, 1 << 64, size=4000, dtype=np.uint64),
                        np.array([0, 1, 1 << 32, 1 << 33, 1 << 63,
                                  (1 << 64) - 1, (1 << 33) - 1],
                                 dtype=np.uint64)])
    np.testing.assert_array_equal(srol1(v), srol_pow_port(v, 1))
    np.testing.assert_array_equal(sror1(v), srol_pow_port(v, -1))
    np.testing.assert_array_equal(sror1(srol1(v)), v)


def roll_model(codes: np.ndarray, k: int, run: int):
    """fh, rh uint64 [B, W] and valid bool [B, W] as the kernel computes
    them: each run of `run` windows starts from the all-N window, rolls in
    k bases with out-base N, then rolls one base a window."""
    B, L = codes.shape
    W = L - k + 1
    c = np.minimum(codes, T.CODE_N).astype(np.int64)
    f_tab, r_tab = (t.reshape(-1) for t in tables(k))
    fh = np.zeros((B, W), np.uint64)
    rh = np.zeros((B, W), np.uint64)
    ok = np.zeros((B, W), bool)
    for p in range(0, W, run):
        f = np.zeros(B, np.uint64)
        r = np.zeros(B, np.uint64)
        n = np.zeros(B, np.int64)
        for j in range(k):
            cj = c[:, p + j]
            f = srol1(f) ^ f_tab[T.CODE_N * 5 + cj]
            r = sror1(r) ^ r_tab[T.CODE_N * 5 + cj]
            n += cj == T.CODE_N
        for q in range(run):
            if p + q >= W:
                break
            fh[:, p + q], rh[:, p + q], ok[:, p + q] = f, r, n == 0
            if q + 1 < run and p + q + 1 < W:
                o, i = c[:, p + q], c[:, p + q + k]
                f = srol1(f) ^ f_tab[o * 5 + i]
                r = sror1(r) ^ r_tab[o * 5 + i]
                n += (i == T.CODE_N).astype(np.int64) - (o == T.CODE_N)
    return fh, rh, ok


def check_model(codes, k, run):
    ref = jax.jit(functools.partial(jax_nthash.strand_hashes, k=k))(
        jnp.asarray(codes))
    fh, rh, ok = roll_model(codes, k, run)
    np.testing.assert_array_equal(fh, ref.fh.astype_numpy())
    np.testing.assert_array_equal(rh, ref.rh.astype_numpy())
    np.testing.assert_array_equal(ok, np.asarray(ref.valid))


def codes_with_run_edges(B, L, k, run, seed):
    """Random codes with 2% N, plus an N at the first and the last base of
    a run and at the base a run's last roll step takes in."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = T.CODE_N
    W = L - k + 1
    if W > run:
        codes[0, run] = T.CODE_N                 # first base of run 1
        codes[1 % B, run - 1] = 200              # last base of run 0
        codes[2 % B, run - 1 + k] = T.CODE_N     # run 0's last step takes in
    return codes


@pytest.mark.parametrize("k", K_VALUES)
def test_roll_model_matches_jax(k):
    # W = 2 * run + 3: not a multiple of the run
    run = nthash_scan.run_length(k)
    check_model(codes_with_run_edges(3, k + 2 * run + 2, k, run, k), k, run)


@pytest.mark.parametrize("k,L,run", [
    (31, 31, 16),     # L == k: W == 1
    (31, 35, 16),     # W < run
    (31, 300, 32),
    (31, 300, 16),
    (129, 150, 16),   # W < run at k > 128
    (2, 2, 16),
    (64, 64, 32),
    (64, 200, 32),
])
def test_roll_model_run_boundaries(k, L, run):
    check_model(codes_with_run_edges(3, L, k, run, L + run), k, run)


@pytest.mark.parametrize("size", [1, 3, 1000, 1 << 20, (1 << 31) + 1,
                                  (1 << 32) - 64, (1 << 32) - 1])
def test_barrett_pair_reduces_and_is_cached(size):
    magic, shift = nthash_scan.barrett(size)
    assert nthash_scan.barrett(size) is nthash_scan.barrett(size)
    rng = np.random.default_rng(size % 997)
    vals = [int(v) for v in rng.integers(0, 1 << 64, size=500,
                                         dtype=np.uint64)]
    vals += [0, 1, size - 1, size, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    for v in vals:
        if magic == 0:      # a power of two: the kernel masks
            got = v & (size - 1)
        else:               # mod_size in csrc/nthash_scan.cu
            q = ((v * magic) >> 64) >> shift
            got = v - q * size
            assert 0 <= got < 2 * size
            got = got - size if got >= size else got
        assert got == v % size


@pytest.mark.parametrize("k,run", [(1, 16), (31, 16), (63, 16), (64, 32),
                                   (129, 32), (1025, 32)])
def test_run_length_rule(k, run):
    """Runs of 16 windows below k=64, of 32 from there (the kernel takes
    only these two)."""
    assert nthash_scan.run_length(k) == run


def test_tile_matches_the_source():
    """The wrapper's tile size is the kernel's (``#define TILE``)."""
    with open(os.path.join(_build.CSRC, "nthash_scan.cu")) as f:
        tile = re.search(r"^#define TILE (\d+)", f.read(), re.M).group(1)
    assert int(tile) == nthash_scan.TILE
