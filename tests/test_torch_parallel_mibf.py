"""The port's sharded MIBF build and lookups
(``btl_bloomfilter_tpu_torch.parallel.dist_mibf``) on gloo rank processes
at P = 2, 4 and 8, held bit for bit against the JAX package's
``dist_mibf`` on the conftest's virtual CPU mesh at the same world size
and against the single-device pipeline: phases 1-4 (bit-vector shards,
local cumulative ranks, rank bases, shard populations, the rank-aligned ID
and count shards), ``at_rank_data`` and ``saturate``. The twins of
``tests/test_parallel.py``'s sharded MIBF build (64 words a shard of 8)
and saturate tests; ``test_torch_parallel_mibf_odd.py`` has the build of
37 words a shard of 8.
"""

import pytest

import torch_parallel_cases as cases
import torch_parallel_mibf_checks as checks


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    p = request.param
    return p, cases.run_cases(tmp_path_factory.mktemp(f"mibf{p}"),
                              ["mibf_build_64", "mibf_saturate"], p)


def test_sharded_mibf_build_and_query_matches_single(ranks):
    checks.check_build(*ranks, 64)


def test_sharded_mibf_saturate_matches_single(ranks):
    checks.check_saturate(*ranks)
