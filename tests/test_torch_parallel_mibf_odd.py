"""The port's sharded MIBF build and lookups at 37 words a shard of 8
(9,472 bits: at P = 2, 4 and 8 no shard size is a power of two), held bit
for bit against the JAX package's ``dist_mibf`` at the same world size
and the single-device pipeline: the twin of ``tests/test_parallel.py``'s
``test_sharded_mibf_build_and_query_matches_single[37]``.
"""

import pytest

import torch_parallel_cases as cases
import torch_parallel_mibf_checks as checks


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    p = request.param
    return p, cases.run_cases(tmp_path_factory.mktemp(f"mibf_odd{p}"),
                              ["mibf_build_37"], p)


def test_sharded_mibf_build_and_query_matches_single(ranks):
    checks.check_build(*ranks, 37)
