"""Classification against the port's sharded MIBF
(``dist_mibf.ShardedMIBFQuerySupport``) on gloo rank processes, each rank
classifying its block of the reads: the ranked QueryResults of single
reads and of pairs, and the sat and eval counts, held against the JAX
package's sharded engine at the same world size and the single-device
engine. The twin of ``tests/test_parallel.py``'s
``test_sharded_classification_matches_single`` at P = 2 and 4;
``test_torch_parallel_classify_p8.py`` runs P = 8 and the single-device
engine (a JAX engine compiles for each world size, so the two files
share the time).
"""

import pytest

import torch_parallel_cases as cases
import torch_parallel_mibf_checks as checks


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    p = request.param
    return p, cases.run_cases(tmp_path_factory.mktemp(f"classify{p}"),
                              ["mibf_classify"], p)


def test_sharded_classification_matches_single(ranks):
    checks.check_classify(*ranks)
