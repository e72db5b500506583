"""The port's entry points that build, load or hash state run on the card
unless the caller asks for the CPU: their ``device`` defaults to "cuda",
and without a card they raise instead of moving to the CPU by themselves.
"""

import datetime
import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist

from btl_bloomfilter_tpu_torch import api, compat
from btl_bloomfilter_tpu_torch.io import bf_format, mibf_format
from btl_bloomfilter_tpu_torch.models import (blocked, bloom, counting,
                                              mibf, mibf_construct)
from btl_bloomfilter_tpu_torch.parallel import (dist_bloom, dist_counting,
                                                dist_mibf, multihost)
from btl_bloomfilter_tpu_torch.parallel import mesh as mesh_lib
from btl_bloomfilter_tpu_torch.tools import dist_run
from btl_bloomfilter_tpu_torch.probes import (kernel_lab, partition_probe,
                                              ring_probe, vmem_sort_probe)

ENTRY_POINTS = [
    bloom.create, bloom.create_from_fpr, bloom.from_numpy_words,
    counting.create, counting.from_bytes, counting.from_numpy_counters,
    bf_format.load_bloom, bf_format.load_counting, api.HashPipeline,
    mibf.from_numpy, mibf_construct.create, mibf_format.load_mibf,
    ring_probe.make_codes, vmem_sort_probe.make_keys,
    partition_probe.make_keys, partition_probe.dma_sweep,
    kernel_lab.make_inputs, compat.BloomFilter, compat.KmerBloomFilter,
    compat.CountingBloomFilter, compat.MIBloomFilter,
    compat.MIBFConstructSupport, multihost.init, blocked.create,
    blocked.from_numpy_rows, blocked.load,
]


@pytest.mark.parametrize("fn", ENTRY_POINTS,
                         ids=lambda f: f"{f.__module__}.{f.__qualname__}")
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("make", [
    lambda: bloom.create(64, 2, 5),
    lambda: counting.create(64, 2, 5, 1),
    lambda: mibf_construct.create(100, 5, 2),
    lambda: mibf_construct.create(100, 5, 4, spaced_seeds=("11011", "11011")),
    lambda: mibf.from_numpy(np.zeros(2, np.uint32), np.zeros(0, np.uint16),
                            size=64, hash_num=2, kmer_size=5, data_width=2),
    lambda: compat.BloomFilter(64, 2, 5)._bf,
    lambda: compat.CountingBloomFilter(64, 2, 5, 1)._cbf,
    lambda: compat.MIBFConstructSupport(100, 5, 2)._state,
    lambda: compat.MIBloomFilter(2, 5, np.zeros(2, np.uint32))._m,
    lambda: blocked.create(1024, 3, 5),
    lambda: blocked.from_numpy_rows(np.zeros((2, 16), np.uint32), 1024, 3,
                                    5),
])
def test_default_device_is_the_card(make):
    """With a card the state lands on it; without one the call raises."""
    if torch.cuda.is_available():
        state = make()
        for name in ("words", "counters", "bv_words", "rows"):
            if hasattr(state, name):
                assert getattr(state, name).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make()


@pytest.mark.parametrize("main,argv", [
    (ring_probe.main, ["--rows", "2", "--length", "64", "--log2-size",
                       "16"]),
    (vmem_sort_probe.main, ["--n", "2048"]),
    (partition_probe.main, ["--n", "1024", "--nsteps", "1"]),
    (kernel_lab.main, ["--log2-size", "19", "--n", "1024"]),
], ids=["ring_probe", "vmem_sort_probe", "partition_probe", "kernel_lab"])
def test_probe_mains_default_to_the_card(main, argv):
    """Without --device a probe runs on the card; without a card it
    raises."""
    if torch.cuda.is_available():
        main(argv + ["--reps", "1"])
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            main(argv + ["--reps", "1"])


def test_seeded_hash_pipeline_defaults_to_the_card():
    """The spaced-seed HashPipeline hashes on the card unless asked for the
    CPU; without a card it raises."""
    hp = api.HashPipeline(5, 4, ("11011", "10111"))
    assert hp.device == torch.device("cuda")
    codes = np.zeros(40, np.uint8)
    if torch.cuda.is_available():
        assert hp.frames(codes).hashes.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            hp.frames(codes)


def test_parallel_defaults_to_the_card(tmp_path):
    """The distribution layer's mesh is the card's unless the caller names
    another device; the sharded filters live on the mesh's device (so
    without a card creating one raises), and the rank launcher's ranks
    take the mesh's default."""
    assert inspect.signature(mesh_lib.make_mesh).parameters[
        "device"].default is None
    assert inspect.signature(dist_run.launch).parameters[
        "device"].default is None
    multihost.init(f"file://{tmp_path / 'store'}", 1, 0, device="cpu",
                   timeout=datetime.timedelta(seconds=30))
    try:
        assert dist.get_backend() == "gloo"
        mesh = mesh_lib.make_mesh()
        assert mesh.device.type == "cuda" and mesh.size == 1
        makers = [lambda: dist_bloom.create_sharded(mesh, 1024, 2, 5),
                  lambda: dist_counting.create_sharded(mesh, 64, 2, 5, 1),
                  lambda: dist_mibf.create_bv(mesh, 100, 5, 2)]
        for make in makers:
            if torch.cuda.is_available():
                state = make()
                state = state[0] if isinstance(state, tuple) else state
                for name in ("words", "counters"):
                    if hasattr(state, name):
                        assert getattr(state, name).device.type == "cuda"
            else:
                with pytest.raises((RuntimeError, AssertionError)):
                    make()
        cpu = mesh_lib.make_mesh(device="cpu")
        assert dist_bloom.create_sharded(cpu, 1024, 2, 5).words.device == \
            torch.device("cpu")
    finally:
        multihost.shutdown()


def test_blocked_load_defaults_to_the_card(tmp_path):
    """A stored blocked filter loads onto the card unless the caller asks
    for the CPU; without a card the load raises."""
    path = str(tmp_path / "b.bbf")
    blocked.store(blocked.create(1024, 3, 5, device="cpu"), path)
    assert blocked.load(path, device="cpu").rows.device.type == "cpu"
    if torch.cuda.is_available():
        assert blocked.load(path).rows.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            blocked.load(path)
