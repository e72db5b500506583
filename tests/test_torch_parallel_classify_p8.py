"""Classification against the port's sharded MIBF
(``dist_mibf.ShardedMIBFQuerySupport``) on gloo rank processes, each rank
classifying its block of the reads: the ranked QueryResults of single
reads and of pairs, and the sat and eval counts, held against the JAX
package's sharded engine at the same world size and the single-device
engine. The twin of ``tests/test_parallel.py``'s
``test_sharded_classification_matches_single`` at P = 8, also against
the single-device engine; ``test_torch_parallel_classify.py`` runs P = 2
and 4.
"""

import pytest

import torch_parallel_cases as cases
import torch_parallel_mibf_checks as checks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return 8, cases.run_cases(tmp_path_factory.mktemp("classify8"),
                              ["mibf_classify"], 8)


def test_sharded_classification_matches_single(ranks):
    checks.check_classify(*ranks, single=True)
