"""The port's block-local sorts, plain PyTorch path: ``sort_blocks``
(2048-key blocks) against the JAX package's ``kernels/vmem_sort.py:
sort_blocks`` in interpret mode, and ``chunk_bitonic`` (1024-key chunks)
against the Pallas body of ``bench/partition_probe.py`` (``_bitonic_kernel``)
run through ``pl.pallas_call(..., interpret=True)``.

The probe file is loaded from its path without edits; the JAX compilation
cache it enables on import is switched off for that import, and ``sys.path``
is restored after it. Keys are made with numpy from fixed seeds and include
duplicates and the extremes 0, 0x7FFFFFFF, 0x80000000 and 0xFFFFFFFF, which
must sort in unsigned order. The outputs are integers: tolerance zero.
"""

import importlib.util
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from btl_bloomfilter_tpu.kernels import vmem_sort as jax_vmem_sort
from btl_bloomfilter_tpu.utils import platform as jax_platform
from btl_bloomfilter_tpu_torch.kernels import vmem_sort
from btl_bloomfilter_tpu_torch.probes import partition_probe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTREMES = np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def load_bench_probe(name):
    """bench/<name>.py as a module, without its compilation cache."""
    saved = list(sys.path)
    try:
        with mock.patch.object(jax_platform, "enable_compilation_cache",
                               lambda *a, **k: None):
            spec = importlib.util.spec_from_file_location(
                f"_bench_{name}", os.path.join(ROOT, "bench", f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    elif kind == "duplicates":
        x = rng.integers(0, 8, size=n, dtype=np.uint32)
    else:       # the extremes, scattered among random and duplicate keys
        x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        pick = rng.random(n) < 0.3
        x[pick] = rng.choice(EXTREMES, size=int(pick.sum()))
        x[: 4 * len(EXTREMES)] = np.repeat(EXTREMES[::-1], 4)
        x[-5:] = 0x80000000
    return x


def as_i32(a):
    return torch.from_numpy(a.view(np.int32).copy())


def numpy_block_sort(x, block):
    return np.sort(x.reshape(-1, block), axis=-1).reshape(-1)


@pytest.mark.parametrize("kind", ["random", "duplicates", "extremes"])
def test_sort_blocks_matches_jax(kind):
    x = keys(kind, vmem_sort.BLOCK * 3, len(kind))
    ref = np.asarray(jax_vmem_sort.sort_blocks(jnp.asarray(x),
                                               interpret=True))
    got = vmem_sort.sort_blocks(as_i32(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(ref, numpy_block_sort(x, vmem_sort.BLOCK))


@pytest.fixture(scope="module")
def bench_partition_probe():
    return load_bench_probe("partition_probe")


@pytest.mark.parametrize("kind", ["random", "duplicates", "extremes"])
def test_chunk_bitonic_matches_probe_body(bench_partition_probe, kind):
    chunk = partition_probe.CHUNK
    assert chunk == bench_partition_probe.CHUNK
    x = keys(kind, chunk * 3, 10 + len(kind))
    nchunks = len(x) // chunk
    run = jax.jit(pl.pallas_call(
        bench_partition_probe._bitonic_kernel,
        grid=(nchunks,),
        in_specs=[pl.BlockSpec((1, 8, 128), lambda c: (c, 0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda c: (c, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((nchunks, 8, 128), jnp.uint32),
        interpret=True))
    ref = np.asarray(run(jnp.asarray(x).reshape(nchunks, 8, 128))).reshape(-1)
    got = partition_probe.chunk_bitonic(as_i32(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(ref, numpy_block_sort(x, chunk))


def test_probe_keys_match_jax_probe():
    """The partition probe's keys are the JAX probe's."""
    n = 5000
    i = np.arange(n, dtype=np.uint32)
    ref = (i * np.uint32(0x9E3779B9)) ^ (i >> np.uint32(16))
    got = partition_probe.make_keys(n, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)


@pytest.mark.parametrize("fn,block", [(vmem_sort.sort_blocks, 2048),
                                      (vmem_sort.chunk_bitonic, 1024)])
def test_block_sorts_check_their_input(fn, block):
    assert fn(torch.zeros(0, dtype=torch.int32)).numel() == 0
    with pytest.raises(ValueError):
        fn(torch.zeros(block + 1, dtype=torch.int32))
    with pytest.raises(TypeError):
        fn(torch.zeros(block, dtype=torch.int64))
