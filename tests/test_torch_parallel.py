"""The port's distribution layer (``btl_bloomfilter_tpu_torch.parallel``)
on gloo rank processes, held bit for bit against the JAX package's
``parallel`` functions on the conftest's virtual CPU mesh at the same
world size: the OR and saturating-add allreduces, the replicated and the
sharded Bloom filter (``rerouted`` under ``cap=2`` included) and the
data-parallel counting filter, at P = 2, 4 and 8, and the fallbacks of a
world that is not a power of two at P = 3. The twins of
``tests/test_parallel.py``'s first eight tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from btl_bloomfilter_tpu.models import bloom, counting, kmer_bloom
from btl_bloomfilter_tpu.ops import nthash
from btl_bloomfilter_tpu.parallel import (collectives, dist_bloom,
                                          dist_counting)
from btl_bloomfilter_tpu.parallel import mesh as mesh_lib
from btl_bloomfilter_tpu_torch.parallel import dist_bloom as t_dist_bloom

import torch_parallel_cases as cases
from torch_parallel_cases import joined, rand_codes, rows_size


@functools.lru_cache(maxsize=None)
def jmesh(p):
    return mesh_lib.make_mesh(p)


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    p = request.param
    out = cases.run_cases(tmp_path_factory.mktemp(f"bloom{p}"),
                          cases.BLOOM_CASES, p)
    return p, out


@pytest.fixture(scope="module")
def ranks3(tmp_path_factory):
    return 3, cases.run_cases(tmp_path_factory.mktemp("bloom3"),
                              cases.BLOOM_CASES3, 3)


def _jax_or(fn, x, p):
    def local(xs):
        return fn(xs[0])[None]
    return np.asarray(jax.jit(shard_map(local, mesh=jmesh(p),
                                        in_specs=P(mesh_lib.AXIS),
                                        out_specs=P(mesh_lib.AXIS)))(x))


def check_or(p, out, case, fn, width, seed):
    x = cases.or_inputs(p, width, seed)
    jax_out = _jax_or(fn, x, p)
    expect = np.bitwise_or.reduce(x, axis=0)
    for r, o in enumerate(out(case)):
        np.testing.assert_array_equal(o["out"], jax_out[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(o["out"], expect)


@functools.lru_cache(maxsize=None)
def single_dp_bloom(rows, size):
    c = cases.DP_BLOOM
    codes = rand_codes(rows, c["L"], c["seed"])
    return np.asarray(kmer_bloom.insert_seq(
        bloom.create(size, c["h"], c["k"]), codes).words)


@functools.lru_cache(maxsize=None)
def single_sharded(case, rows, size):
    c = cases.SHARDED_BLOOM if case == "sharded_bloom" else cases.OVERFLOW
    f = nthash.hash_frames(jnp.asarray(rand_codes(rows, c["L"], c["seed"])),
                           c["k"], c["h"])
    return np.asarray(bloom.insert(bloom.create(size, c["h"], c["k"]),
                                   f.hashes, f.valid).words)


@functools.lru_cache(maxsize=None)
def single_dp_counting():
    c = cases.DP_COUNTING
    f = nthash.hash_frames(jnp.asarray(rand_codes(c["rows"], c["L"],
                                                  c["seed"])), c["k"], c["h"])
    return counting.to_numpy(counting.insert_all(
        counting.create(c["nbytes"], c["h"], c["k"], 1, counter_width=1),
        f.hashes, f.valid))


def check_dp_bloom(p, out):
    c = cases.DP_BLOOM
    rows, size = rows_size(c, p)
    codes = rand_codes(rows, c["L"], c["seed"])
    bf = dist_bloom.dp_insert_seq(jmesh(p), bloom.create(size, c["h"],
                                                         c["k"]), codes)
    hits, valid = dist_bloom.dp_contains_seq(jmesh(p), bf, codes)
    outs = out("dp_bloom")
    for o in outs:
        np.testing.assert_array_equal(o["words"], np.asarray(bf.words))
    np.testing.assert_array_equal(joined(outs, "hits"), np.asarray(hits))
    np.testing.assert_array_equal(joined(outs, "valid"), np.asarray(valid))
    # the single-device build, as the JAX test holds its own
    np.testing.assert_array_equal(outs[0]["words"], single_dp_bloom(rows,
                                                                    size))


def check_sharded(p, out, case, c, cap):
    rows, size = rows_size(c, p)
    f = nthash.hash_frames(jnp.asarray(rand_codes(rows, c["L"], c["seed"])),
                           c["k"], c["h"])
    sbf = dist_bloom.create_sharded(jmesh(p), size, c["h"], c["k"])
    sbf, rerouted = dist_bloom.sharded_insert_frames(
        jmesh(p), sbf, f.hashes, f.valid, cap=cap)
    got = dist_bloom.sharded_contains_frames(jmesh(p), sbf, f.hashes,
                                             cap=cap)
    outs = out(case)
    np.testing.assert_array_equal(joined(outs, "words"),
                                  np.asarray(sbf.words).reshape(-1))
    np.testing.assert_array_equal(joined(outs, "hits"), np.asarray(got))
    for o in outs:
        assert int(o["rerouted"]) == int(rerouted)
    # the single-device filter
    np.testing.assert_array_equal(joined(outs, "words"),
                                  single_sharded(case, rows, size))
    return int(rerouted), joined(outs, "hits"), joined(outs, "valid")


def test_or_allreduce_butterfly(ranks):
    p, out = ranks
    check_or(p, out, "or_butterfly", collectives.or_allreduce_butterfly,
             64, 1)


def test_or_allreduce_rsag(ranks):
    p, out = ranks
    check_or(p, out, "or_rsag", collectives.or_allreduce_rsag, 128, 2)
    # a length the world does not divide takes the butterfly
    check_or(p, out, "or_rsag_odd", collectives.or_allreduce_rsag, 130, 6)


def test_or_allreduce_non_power_of_two(ranks3):
    p, out = ranks3
    check_or(p, out, "or_butterfly", collectives.or_allreduce_butterfly,
             64, 1)
    check_or(p, out, "or_rsag", collectives.or_allreduce_rsag, 128, 2)
    check_or(p, out, "or_rsag_odd", collectives.or_allreduce_rsag, 130, 6)


def test_dp_insert_matches_single_device(ranks):
    check_dp_bloom(*ranks)


def test_dp_insert_non_power_of_two(ranks3):
    check_dp_bloom(*ranks3)


def test_sharded_insert_query_matches_single_device(ranks):
    p, out = ranks
    rerouted, _, _ = check_sharded(p, out, "sharded_bloom",
                                   cases.SHARDED_BLOOM, None)
    assert rerouted == 0


def check_overflow(p, out):
    rerouted, hits, valid = check_sharded(p, out, "sharded_overflow",
                                          cases.OVERFLOW, 2)
    assert rerouted > 0          # the tiny cap really did overflow
    assert hits[valid].all()     # no false negatives


def test_sharded_overflow_repaired_exactly(ranks):
    check_overflow(*ranks)


def test_sharded_overflow_non_power_of_two(ranks3):
    check_overflow(*ranks3)


def test_sharded_default_cap_is_bounded():
    for n, p in ((8000, 8), (10, 8), (4, 8), (123, 3), (1, 2), (0, 4)):
        assert t_dist_bloom._default_cap(n, p) == \
            dist_bloom._default_cap(n, p)
    assert t_dist_bloom._default_cap(8000, 8) == 2000


def test_saturating_add_allreduce(ranks):
    p, out = ranks
    x = np.full((p, 16), 40, dtype=np.uint32)
    jax_out = _jax_or(lambda v: collectives.saturating_add_allreduce(
        v, cap=255), x, p)
    for r, o in enumerate(out("saturating_add")):
        np.testing.assert_array_equal(o["out"], jax_out[r])
        np.testing.assert_array_equal(o["out"], min(40 * p, 255))
        # uint8 counts widen before the sum: 200 * p does not wrap
        np.testing.assert_array_equal(o["u8"], 255)


def test_dp_counting_insert_all_matches_single(ranks):
    p, out = ranks
    c = cases.DP_COUNTING
    codes = rand_codes(c["rows"], c["L"], c["seed"])
    cbf = dist_counting.dp_insert_all_seq(
        jmesh(p), counting.create(c["nbytes"], c["h"], c["k"], 1,
                                  counter_width=1), codes)
    hits, _ = dist_counting.dp_contains_seq(jmesh(p), cbf, codes)
    outs = out("dp_counting")
    for o in outs:
        np.testing.assert_array_equal(o["counters"], counting.to_numpy(cbf))
    np.testing.assert_array_equal(joined(outs, "hits"), np.asarray(hits))
    np.testing.assert_array_equal(outs[0]["counters"], single_dp_counting())


@pytest.mark.parametrize("size", [8 * 32 * 3 + 8, 8 << 32, 8 * 32 * 4])
def test_sharded_size_limits_match_jax(size):
    """The sharded filters keep the JAX package's limits and errors: a
    size that is not a multiple of 32 * P, a shard of 2**32 bits or
    counters or more (checked before any state is made); a size both take
    (the port's state on the meta device)."""
    import torch

    from btl_bloomfilter_tpu_torch.parallel import (
        dist_counting as t_dist_counting)
    from btl_bloomfilter_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(group=None, rank=0, size=8, device=torch.device("meta"))
    for jax_fn, port_fn in (
            (lambda: dist_bloom.create_sharded(jmesh(8), size, 3, 5),
             lambda: t_dist_bloom.create_sharded(mesh, size, 3, 5)),
            (lambda: dist_counting.create_sharded(jmesh(8), size * 8, 3, 5,
                                                  1, 1),
             lambda: t_dist_counting.create_sharded(mesh, size * 8, 3, 5,
                                                    1, 1))):
        try:
            jax_fn()
            jax_error = None
        except ValueError as e:
            jax_error = e
        if jax_error is None:
            port_fn()
        else:
            with pytest.raises(ValueError):
                port_fn()


def test_mesh_row_blocks():
    """Rank r holds rows [r*B/P, (r+1)*B/P): the ranks' blocks joined in
    rank order are the global array (the JAX package's P(AXIS) on axis
    0); a replicated array is whole on every rank; rows P does not divide
    raise."""
    import torch

    from btl_bloomfilter_tpu_torch.parallel import mesh as t_mesh

    x = np.arange(24 * 3).reshape(24, 3)
    for p in (1, 2, 3, 4, 8):
        meshes = [t_mesh.Mesh(None, r, p, torch.device("cpu"))
                  for r in range(p)]
        blocks = [t_mesh.sharded(m, x).numpy() for m in meshes]
        np.testing.assert_array_equal(np.concatenate(blocks), x)
        cols = [t_mesh.sharded(m, x.T, axis=1).numpy() for m in meshes]
        np.testing.assert_array_equal(np.concatenate(cols, axis=1), x.T)
        for m in meshes:
            np.testing.assert_array_equal(t_mesh.replicated(m, x).numpy(), x)
    with pytest.raises(ValueError):
        t_mesh.block(t_mesh.Mesh(None, 0, 5, torch.device("cpu")), 24)
