"""The port's copy of the libstdc++ mirrors (``utils/stdcpp.py``):
``std::shuffle`` driven by ``std::minstd_rand`` against the permutations
the compiled reference toolchain made (``shuffle_golden.jsonl``), the
engine's seeding at its edges against the JAX package's mirror, and the
bounded draws against it. Integers only: the tolerance is zero.
"""

import json
import os

import numpy as np
import pytest

from btl_bloomfilter_tpu.utils import stdcpp as jax_stdcpp
from btl_bloomfilter_tpu_torch.utils import stdcpp

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

with open(os.path.join(GOLDEN_DIR, "shuffle_golden.jsonl")) as f:
    CASES = [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"s{c['seed']}n{c['n']}" for c in CASES])
def test_shuffle_matches_golden(case):
    g = stdcpp.MinstdRand(case["seed"])
    assert stdcpp.shuffle(list(range(case["n"])), g) == case["perm"]
    # the engine's state after the shuffle too (the golden generator
    # evaluates its three printf arguments right to left)
    assert [g(), g(), g()] == case["next"][::-1]


MOD = stdcpp.MinstdRand.MOD


@pytest.mark.parametrize("seed", [
    0, 1, MOD - 1, MOD, MOD + 1, 2 * MOD, 7 * MOD, (1 << 31), (1 << 32) + 5,
    (1 << 63) + 12345, (1 << 64) - 1, 0xDEADBEEFCAFEBABE,
    (1 << 64) // MOD * MOD])
def test_minstd_seeding_edges(seed):
    """The 64-bit seed mod 2147483647, 0 becoming 1 (multiples of the
    modulus included), and the draws after it, as the JAX mirror gives."""
    a, b = stdcpp.MinstdRand(seed), jax_stdcpp.MinstdRand(seed)
    assert a.x == b.x and 1 <= a.x < MOD
    if seed % MOD == 0:
        assert a.x == 1
    assert [a() for _ in range(20)] == [b() for _ in range(20)]


def test_bounded_draws_match_jax():
    rng = np.random.default_rng(0)
    for seed in rng.integers(0, 1 << 63, size=50, dtype=np.int64).tolist():
        a, b = stdcpp.MinstdRand(seed), jax_stdcpp.MinstdRand(seed)
        for hi in (1, 2, 5, 56, 4095, MOD - 3):
            assert stdcpp.uniform_int(a, 0, hi) == jax_stdcpp.uniform_int(
                b, 0, hi)
        n = int(rng.integers(0, 40))
        assert stdcpp.shuffle(range(n), a) == jax_stdcpp.shuffle(range(n), b)


def test_std_hash_identity():
    assert stdcpp.std_hash_integral(0xDEADBEEFCAFEBABE, 64) == \
        0xDEADBEEFCAFEBABE
    assert stdcpp.std_hash_integral(0xDEADBEEFCAFEBABE, 16) == 0xBABE
    assert stdcpp.std_hash_integral(0x1FF, 8) == 0xFF
