"""The port's sharded counting Bloom filter
(``btl_bloomfilter_tpu_torch.parallel.dist_counting``) on gloo rank
processes at P = 2, 4 and 8, held bit for bit against the JAX package's
``dist_counting`` on the conftest's virtual CPU mesh at the same world
size and against the single-device filter: incrementAll with and without
a send cap, saturation across a tiny plane, the exact conservative
update (entangled streams, a small ``max_entangled``) and width 8. The
twins of ``tests/test_parallel.py``'s sharded counting tests.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from btl_bloomfilter_tpu.models import counting
from btl_bloomfilter_tpu.ops import nthash
from btl_bloomfilter_tpu.parallel import dist_counting
from btl_bloomfilter_tpu.parallel import mesh as mesh_lib

import torch_parallel_cases as cases
from torch_parallel_cases import joined, rand_codes


@functools.lru_cache(maxsize=None)
def jmesh(p):
    return mesh_lib.make_mesh(p)


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    p = request.param
    return p, cases.run_cases(tmp_path_factory.mktemp(f"counting{p}"),
                              cases.COUNTING_CASES, p)


@functools.lru_cache(maxsize=None)
def jframes(name):
    c = getattr(cases, name)
    f = nthash.hash_frames(jnp.asarray(rand_codes(c["rows"], c["L"],
                                                  c["seed"])), c["k"], c["h"])
    return c, f


def jpair(name, p):
    """(single-device filter, sharded filter, frames) of a case."""
    c, f = jframes(name)
    cbf = counting.create(c["nbytes"], c["h"], c["k"], 1,
                          counter_width=c["width"])
    scbf = dist_counting.create_sharded(jmesh(p), c["nbytes"], c["h"],
                                        c["k"], 1, counter_width=c["width"])
    assert scbf.size == cbf.size
    return cbf, scbf, f


def plane(scbf) -> np.ndarray:
    """The JAX sharded counters joined, one a counter (width 8 as uint64)."""
    a = np.asarray(scbf.counters)
    if scbf.is_u64:
        return (a[:, 0].astype(np.uint64)
                | (a[:, 1].astype(np.uint64) << np.uint64(32))).reshape(-1)
    return a.reshape(-1)


def u64_of(mc) -> np.ndarray:
    """A JAX min count as uint64 (width 8: the [2, ...] limb planes)."""
    a = np.asarray(mc)
    if a.ndim and a.shape[0] == 2 and a.dtype == np.uint32:
        return a[0].astype(np.uint64) | (a[1].astype(np.uint64)
                                         << np.uint64(32))
    return a.astype(np.uint64)


@functools.lru_cache(maxsize=None)
def single(name, op):
    cbf, _, f = jpair(name, 2)
    if op == "all":
        cbf = counting.insert_all(cbf, f.hashes, f.valid)
    elif op == "sequential":
        cbf = counting.insert_sequential(cbf, f.hashes, f.valid)
    else:
        cbf = counting.insert(cbf, f.hashes, f.valid)
    mc = counting.min_count(cbf, f.hashes)
    mc = (np.asarray(mc.lo).astype(np.uint64)
          | (np.asarray(mc.hi).astype(np.uint64) << np.uint64(32))
          ) if cbf.is_u64 else np.asarray(mc).astype(np.uint64)
    return cbf, counting.to_numpy(cbf), mc


@pytest.mark.parametrize("cap", [None, 2])  # cap=2 forces overflow rounds
def test_sharded_counting_insert_all_matches_single(ranks, cap):
    p, out = ranks
    _, scbf, f = jpair("C_INSERT_ALL", p)
    scbf = dist_counting.sharded_insert_all(jmesh(p), scbf, f.hashes,
                                            f.valid, cap=cap)
    outs = out("counting_insert_all")
    np.testing.assert_array_equal(joined(outs, f"counters_{cap}"),
                                  plane(scbf))
    cbf, counters, mc1 = single("C_INSERT_ALL", "all")
    np.testing.assert_array_equal(joined(outs, f"counters_{cap}"), counters)
    mc2 = dist_counting.sharded_min_count(jmesh(p), scbf, f.hashes, cap=cap)
    np.testing.assert_array_equal(joined(outs, f"min_count_{cap}"),
                                  u64_of(mc2))
    np.testing.assert_array_equal(joined(outs, f"min_count_{cap}"), mc1)
    c2 = dist_counting.sharded_contains(jmesh(p), scbf, f.hashes, cap=cap)
    np.testing.assert_array_equal(joined(outs, f"contains_{cap}"),
                                  np.asarray(c2))
    np.testing.assert_array_equal(joined(outs, f"contains_{cap}"),
                                  np.asarray(counting.contains(cbf,
                                                               f.hashes)))


def test_sharded_counting_insert_all_cap_overflow_saturates_exactly(ranks):
    """64 u8 counters and a heavy stream: the saturating adds compose
    exactly (min(min(c+a,M)+b,M) == min(c+a+b,M))."""
    p, out = ranks
    _, scbf, f = jpair("C_HEAVY_ALL", p)
    scbf = dist_counting.sharded_insert_all(jmesh(p), scbf, f.hashes,
                                            f.valid, cap=2)
    got = joined(out("counting_heavy_all"), "counters")
    np.testing.assert_array_equal(got, plane(scbf))
    np.testing.assert_array_equal(got, single("C_HEAVY_ALL", "all")[1])
    assert got.max() == 255  # saturation really happened


def test_sharded_counting_conservative_insert_matches_single(ranks):
    p, out = ranks
    _, scbf, f = jpair("C_CONSERVATIVE", p)
    scbf = dist_counting.sharded_insert(jmesh(p), scbf, f.hashes, f.valid)
    got = joined(out("counting_conservative"), "counters")
    np.testing.assert_array_equal(got, plane(scbf))
    np.testing.assert_array_equal(got, single("C_CONSERVATIVE", "insert")[1])


@pytest.mark.parametrize("max_entangled", [None, 4])
def test_sharded_counting_conservative_entangled_heavy(ranks, max_entangled):
    """64 counters, h=4: nearly every frame entangles; the replicated
    replay, and the whole-batch replay past a tiny ``max_entangled``,
    equal the sequential stream."""
    p, out = ranks
    _, scbf, f = jpair("C_ENTANGLED", p)
    scbf = dist_counting.sharded_insert(jmesh(p), scbf, f.hashes, f.valid,
                                        max_entangled=max_entangled)
    got = joined(out("counting_entangled"), f"counters_{max_entangled}")
    np.testing.assert_array_equal(got, plane(scbf))
    np.testing.assert_array_equal(got, single("C_ENTANGLED", "sequential")[1])


def test_sharded_counting_u64_width8_matches_single(ranks):
    """Width 8 (uint64 counters): conservative insert, incrementAll on top,
    min count and membership."""
    p, out = ranks
    _, scbf, f = jpair("C_WIDTH8", p)
    outs = out("counting_width8")
    scbf = dist_counting.sharded_insert(jmesh(p), scbf, f.hashes, f.valid)
    np.testing.assert_array_equal(joined(outs, "conservative"), plane(scbf))
    np.testing.assert_array_equal(joined(outs, "conservative"),
                                  single("C_WIDTH8", "insert")[1])
    scbf = dist_counting.sharded_insert_all(jmesh(p), scbf, f.hashes,
                                            f.valid)
    np.testing.assert_array_equal(joined(outs, "all"), plane(scbf))
    cbf, _, _ = single("C_WIDTH8", "insert")
    cbf = counting.insert_all(cbf, f.hashes, f.valid)
    np.testing.assert_array_equal(joined(outs, "all"),
                                  counting.to_numpy(cbf))
    mc2 = dist_counting.sharded_min_count(jmesh(p), scbf, f.hashes)
    np.testing.assert_array_equal(joined(outs, "min_count"), u64_of(mc2))
    c2 = dist_counting.sharded_contains(jmesh(p), scbf, f.hashes)
    np.testing.assert_array_equal(joined(outs, "contains"), np.asarray(c2))
    np.testing.assert_array_equal(joined(outs, "contains"),
                                  np.asarray(counting.contains(cbf,
                                                               f.hashes)))
