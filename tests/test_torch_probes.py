"""The port's probes (``btl_bloomfilter_tpu_torch/probes/``), plain PyTorch
path, at small sizes:

  * the window scatter (``kernels/window_scatter.py``, both variants)
    against the Pallas body of ``bench/kernel_lab.py`` (``make_kernel``,
    ``null`` and ``lanemaj``) run through ``pl.pallas_call(...,
    interpret=True)`` with the probe's own grid spec, the probe file
    loaded from its path as ``tests/test_torch_block_sort.py`` loads it;
  * the copy sweep (``kernels/dma_sweep.py``) against its source;
  * the ring probe's insert step (all three forms) against the JAX
    package's ``bloom.insert`` of the same reads;
  * each probe's ``main`` end to end on the CPU.

Inputs are made with numpy from fixed seeds; all outputs are integers or
bools, so the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu_torch.kernels import (dma_sweep, scatter_or,
                                               window_scatter)
from btl_bloomfilter_tpu_torch.models import bloom
from btl_bloomfilter_tpu_torch.probes import (kernel_lab, partition_probe,
                                              ring_probe, vmem_sort_probe)
from test_torch_block_sort import load_bench_probe

torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)
WIN = window_scatter.WIN_WORDS
CHUNK = window_scatter.CHUNK


@pytest.fixture(scope="module")
def lab():
    mod = load_bench_probe("kernel_lab")
    assert (mod.WIN_WORDS, mod.CHUNK) == (WIN, CHUNK)
    return mod


def jax_window_run(lab, variant, slots, nwords, nchunks):
    """bench/kernel_lab.py:build with interpret=True."""
    nwin = nwords // WIN
    whi = WIN // 128

    def pos_spec(s):
        return pl.BlockSpec((CHUNK,), lambda w, idx: (idx[s, w],),
                            memory_space=pltpu.VMEM)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(nwin,),
        in_specs=[pos_spec(s) for s in range(slots)] + [
            pl.BlockSpec((whi, 128), lambda w, idx: (w, 0),
                         memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((whi, 128), lambda w, idx: (w, 0),
                               memory_space=pltpu.VMEM))

    @jax.jit
    def run(idx, pos, words2d):
        return pl.pallas_call(
            lab.make_kernel(variant, slots), grid_spec=grid_spec,
            out_shape=jax.ShapeDtypeStruct((nwin * whi, 128), jnp.uint32),
            input_output_aliases={slots + 1: 0}, interpret=True,
        )(idx, *([pos] * slots), words2d)
    return run


def window_case(kind, seed):
    """(nwords, sorted positions uint32) of one test case."""
    rng = np.random.default_rng(seed)
    nwords, n = 4 * WIN, 4 * CHUNK
    if kind == "three_windows":
        nwords = 3 * WIN
    if kind in ("uniform", "three_windows"):
        pos = rng.integers(0, nwords * 32, size=n, dtype=np.uint64)
    elif kind == "tile_straddle":       # each side of every window edge
        edges = np.arange(1, 4, dtype=np.uint64) * WIN * 32
        pos = np.concatenate([
            (edges[:, None] + np.arange(-600, 600, dtype=np.int64)
             .astype(np.uint64)).ravel(),
            rng.integers(0, nwords * 32, size=n - 3600, dtype=np.uint64)])
    elif kind == "sentinel_windows":    # windows 2 and 3 reach only chunks
        pos = rng.integers(0, 2 * WIN * 32, size=n, dtype=np.uint64)
        pos[-2 * CHUNK:] = SENT         # of sentinels
    elif kind == "sentinel_tail":       # duplicates, then sentinels last
        pos = rng.integers(0, nwords * 32, size=n, dtype=np.uint64)
        pos[100:140] = pos[99]
        pos[-1500:] = SENT
    else:                               # clustered in windows 1 and 3
        w = rng.choice([1, 3], size=n)
        pos = (w * WIN * 32 + rng.integers(0, WIN * 32, size=n)).astype(
            np.uint64)
    return nwords, np.sort(pos.astype(np.uint32))


def numpy_chunk_index(pos, slots, nwords):
    """The index map of bench/kernel_lab.py:main, in numpy."""
    nchunks = len(pos) // CHUNK
    chunk_last = (pos[CHUNK - 1::CHUNK] >> 5).astype(np.int64)
    wstart = np.arange(nwords // WIN, dtype=np.int64) * WIN
    cs = np.searchsorted(chunk_last, wstart, side="left")
    return np.stack([np.clip(cs + s, 0, nchunks - 1)
                     for s in range(slots)]).astype(np.int32)


@pytest.mark.parametrize("kind,slots", [
    ("uniform", 4), ("uniform", 1), ("sentinel_tail", 2), ("clustered", 3),
    ("tile_straddle", 4), ("three_windows", 4), ("three_windows", 2),
    ("sentinel_windows", 3)])
def test_window_scatter_matches_kernel_lab(lab, kind, slots):
    nwords, pos = window_case(kind, slots)
    nchunks = len(pos) // CHUNK
    rng = np.random.default_rng(slots)
    words = rng.integers(0, 1 << 32, size=(nwords // 128, 128),
                         dtype=np.uint32)
    pos_t = torch.from_numpy(pos.view(np.int32).copy())
    idx = kernel_lab.chunk_index(pos_t, slots, nwords)
    np.testing.assert_array_equal(idx.numpy(),
                                  numpy_chunk_index(pos, slots, nwords))
    refs = {}
    for variant, jax_variant in (("scatter", "lanemaj"), ("null", "null")):
        ref = refs[variant] = np.asarray(jax_window_run(lab, jax_variant, slots, nwords,
                                        nchunks)(
            jnp.asarray(idx.numpy()), jnp.asarray(pos), jnp.asarray(words)))
        w = torch.from_numpy(words.view(np.int32).copy())
        got = kernel_lab.build(variant, slots, nwords, nchunks)(idx, pos_t, w)
        assert got is w
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(refs["null"], words)
    if kind == "sentinel_windows":      # their chunks hold only sentinels
        live = idx.numpy()[:, 2:] * CHUNK
        assert (pos[live[..., None] + np.arange(CHUNK)] == SENT).all()
        np.testing.assert_array_equal(refs["scatter"][2 * WIN // 128:],
                                      words[2 * WIN // 128:])
    if kind == "uniform":   # 4 slots reach every chunk, 1 drops positions
        full = scatter_or.scatter_or_plain(
            torch.from_numpy(words.view(np.int32).reshape(-1).copy()), pos_t)
        assert np.array_equal(full.numpy().view(np.uint32).reshape(
            words.shape), refs["scatter"]) == (slots == 4)


def test_window_scatter_skips_bad_chunks():
    """Chunk indices outside the positions contribute nothing; a repeated
    slot changes nothing."""
    nwords, pos = window_case("uniform", 0)
    pos_t = torch.from_numpy(pos.view(np.int32).copy())
    idx = kernel_lab.chunk_index(pos_t, 2, nwords)
    ref = window_scatter.window_scatter(
        idx, pos_t, torch.zeros(nwords, dtype=torch.int32))
    bad = torch.cat([idx, torch.full_like(idx[:1], -1),
                     torch.full_like(idx[:1], 99), idx[1:]])
    got = window_scatter.window_scatter(
        bad, pos_t, torch.zeros(nwords, dtype=torch.int32))
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        window_scatter.window_scatter(idx, pos_t[:-1],
                                      torch.zeros(nwords, dtype=torch.int32))


@pytest.mark.parametrize("nsteps,k,rows", [(3, 1, 1), (2, 3, 5), (4, 16, 2),
                                           (1, 7, 3)])
def test_dma_sweep_copies_its_source(nsteps, k, rows):
    copy, src = partition_probe.dma_sweep(nsteps, k, rows, device="cpu",
                                          seed=nsteps + k)
    assert src.shape == (nsteps * k * rows, 128) and bool(src.any())
    dst = copy(src)
    assert dst.data_ptr() != src.data_ptr() and torch.equal(dst, src)
    assert torch.equal(dma_sweep.sweep_copy_plain(src, k, rows), src)
    with pytest.raises(ValueError):
        dma_sweep.sweep_copy(src, k, 0)
    with pytest.raises(TypeError):
        dma_sweep.sweep_copy(src[:, :64], k, rows)


def random_codes(rows, length, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(rows, length), dtype=np.uint8)
    return np.where(rng.random((rows, length)) < nfrac, np.uint8(4), codes)


@pytest.mark.parametrize("size", [1 << 20, 999_936])
def test_ring_probe_step_matches_jax_insert(size):
    """The ring probe's three step forms (delta, in place, main path) on a
    small batch against the JAX package's bloom.insert of its frames."""
    codes = random_codes(6, 250, 0.03, size % 101)

    @jax.jit
    def jax_step(c):
        frames = jax_nthash.hash_frames(c, ring_probe.K, ring_probe.H)
        return jax_bloom.insert(
            jax_bloom.create(size, ring_probe.H, ring_probe.K),
            frames.hashes, frames.valid).words

    ref = np.asarray(jax_step(codes))
    codes_t = torch.from_numpy(codes)
    for label, step in ring_probe.steps(size).items():
        words = bloom.create(size, ring_probe.H, ring_probe.K,
                             device="cpu").words
        got = step(words, codes_t)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), ref,
                                      err_msg=label)


@pytest.mark.parametrize("main,argv", [
    (ring_probe.main, ["--rows", "4", "--length", "200", "--log2-size",
                       "20"]),
    (vmem_sort_probe.main, ["--n", "8192"]),
    (partition_probe.main, ["--n", "4096", "--nsteps", "3"]),
    (kernel_lab.main, ["--log2-size", "21", "--n", "8192"]),
], ids=["ring_probe", "vmem_sort_probe", "partition_probe", "kernel_lab"])
def test_probe_main_runs_on_cpu(main, argv):
    res = main(argv + ["--device", "cpu", "--reps", "1"])
    if main is vmem_sort_probe.main:
        assert res["block_sorted_ok"] and res["n"] == 8192
    elif main is partition_probe.main:
        assert set(res["sweep_ms"]) == set(partition_probe.SWEEPS)
    elif main is kernel_lab.main:
        assert res["complete"] and set(res["ms"]) == {"null", "scatter",
                                                      "scatter_or"}
    else:
        assert set(res["ms"]) == {"delta ring", "in-place", "main path"}
