"""Two rank processes over gloo (the twin of ``tests/test_multihost.py``):
each process runs ``tools/dist_run.py``'s rank with the port alone, the
data-parallel build's OR-allreduce crosses the process boundary, every
inserted window is found, and the merged filter equals the JAX package's
single-process build byte for byte. A collective that one rank never
joins fails on the group's timeout, and a rank that hangs outside any
collective is killed at the launcher's time limit, instead of hanging the
run.
"""

import time

import jax
import numpy as np
import pytest

from btl_bloomfilter_tpu.models import bloom
from btl_bloomfilter_tpu.ops import nthash
from btl_bloomfilter_tpu_torch.tools import dist_run

import torch_parallel_cases as cases


def test_two_process_dp_build_matches_single(tmp_path):
    out = cases.run_cases(tmp_path, ["multihost_dp"], 2)
    got = [o["words"] for o in out("multihost_dp")]
    np.testing.assert_array_equal(got[0], got[1])

    c = cases.MULTIHOST
    codes = cases.rand_codes(c["rows"], c["L"], c["seed"])
    bf = bloom.create(c["size"], c["h"], c["k"])
    f = nthash.hash_frames(jax.numpy.asarray(codes), c["k"], c["h"])
    bf = bloom.insert(bf, f.hashes, f.valid)
    np.testing.assert_array_equal(got[0], np.asarray(bf.words))
    assert got[0].any()


def test_unmatched_collective_fails_on_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed"):
        dist_run.launch(cases.__file__, ["unmatched_collective"], 2,
                        str(tmp_path), device="cpu", timeout=5, limit=120)
    assert time.monotonic() - t0 < 60


def test_hung_rank_killed_at_the_launch_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        dist_run.launch(cases.__file__, ["hangs"], 2, str(tmp_path),
                        device="cpu", timeout=60, limit=10)
    assert time.monotonic() - t0 < 45
