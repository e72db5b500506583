"""JAX-side helpers and checks of the port's sharded-MIBF tests: the JAX
package's single-device and sharded builds of a case of
``torch_parallel_cases`` (cached), and the checks that hold the ranks'
outputs against them. Imported by the ``test_torch_parallel_mibf*`` and
``test_torch_parallel_classify`` files.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from btl_bloomfilter_tpu.models import mibf as mibf_mod
from btl_bloomfilter_tpu.models import mibf_construct as construct
from btl_bloomfilter_tpu.models import mibf_query
from btl_bloomfilter_tpu.ops import nthash
from btl_bloomfilter_tpu.parallel import dist_mibf
from btl_bloomfilter_tpu.parallel import mesh as mesh_lib

import torch_parallel_cases as cases
from torch_parallel_cases import joined, rand_codes


@functools.lru_cache(maxsize=None)
def jmesh(p):
    return mesh_lib.make_mesh(p)


@functools.lru_cache(maxsize=None)
def jframes(name):
    c = getattr(cases, name)
    return [nthash.hash_frames(jnp.asarray(s), c["k"], c["h"])
            for s in cases.mibf_seqs(c)]


@functools.lru_cache(maxsize=None)
def single_build(name, size):
    """The single-device build: (after phase 3, after phase 4) as (m,
    counts) pairs."""
    c = getattr(cases, name)
    state = construct.BitVectorState(
        bv_words=jnp.zeros(size // 32, jnp.uint32), filter_size=size,
        kmer_size=c["k"], hash_num=c["h"], occupancy=0.5, sseeds=())
    for f in jframes(name):
        state = construct.insert_bv(state, f.hashes, f.valid)
    m, counts = construct.get_empty_mibf(state, data_width=2)
    for i, f in enumerate(jframes(name)):
        m, counts = construct.insert_mibf(m, counts, f.hashes, i + 1, f.valid)
    m3, counts3 = m, counts
    for i, f in enumerate(jframes(name)):
        m, counts = construct.insert_saturation(m, counts, f.hashes, i + 1,
                                                f.valid)
    return (m3, counts3), (m, counts)


def jax_sharded(name, p, size, saturate):
    """The JAX sharded build at world size p: (after phase 3, final)."""
    c = getattr(cases, name)
    mesh = jmesh(p)
    bvw = jax.device_put(jnp.zeros((p, size // p // 32), jnp.uint32),
                         mesh_lib.sharded(mesh))
    for f in jframes(name):
        bvw = dist_mibf.insert_bv(mesh, bvw, size, f.hashes, f.valid)
    sm = dist_mibf.freeze(mesh, bvw, size, c["h"], c["k"], data_width=2)
    for i, f in enumerate(jframes(name)):
        sm = dist_mibf.insert_mibf(mesh, sm, f.hashes, i + 1, f.valid)
    sm3 = sm
    if saturate:
        for i, f in enumerate(jframes(name)):
            sm = dist_mibf.insert_saturation(mesh, sm, f.hashes, i + 1,
                                             f.valid)
    return sm3, sm


def stacked(outs, key):
    return np.stack([o[key] for o in outs])


def check_build(p, out, nw_per):
    """Phases 1-4 and ``at_rank_data`` of ``mibf_build_<nw_per>``."""
    c = cases.M_BUILD
    size = 8 * 32 * nw_per
    outs = out(f"mibf_build_{nw_per}")
    sm3, sm = jax_sharded("M_BUILD", p, size, True)
    (m1, counts1), (m1s, counts1s) = single_build("M_BUILD", size)

    # phases 1-2: bit-vector shards, local ranks, bases, populations
    np.testing.assert_array_equal(stacked(outs, "bv"),
                                  np.asarray(sm3.bv_words))
    np.testing.assert_array_equal(joined(outs, "bv"),
                                  np.asarray(m1.bv_words))
    np.testing.assert_array_equal(stacked(outs, "cum"),
                                  np.asarray(sm3.cum_ranks))
    for o in outs:
        np.testing.assert_array_equal(o["rank_base"],
                                      np.asarray(sm3.rank_base))
        assert tuple(o["d_sizes"]) == sm3.d_sizes
        assert int(o["d_size"]) == sm3.d_size == m1.d_size
    # phase 3: the rank-aligned shards and the joined arrays
    np.testing.assert_array_equal(stacked(outs, "data3"),
                                  np.asarray(sm3.data))
    np.testing.assert_array_equal(stacked(outs, "counts3"),
                                  np.asarray(sm3.counts))
    np.testing.assert_array_equal(outs[0]["single_data3"], np.asarray(m1.data))
    np.testing.assert_array_equal(outs[0]["single_counts3"],
                                  np.asarray(counts1))
    # phase 4
    np.testing.assert_array_equal(stacked(outs, "data4"),
                                  np.asarray(sm.data))
    np.testing.assert_array_equal(stacked(outs, "counts4"),
                                  np.asarray(sm.counts))
    np.testing.assert_array_equal(outs[0]["single_data4"],
                                  np.asarray(m1s.data))

    # sharded lookups: at_rank_data against the sharded and single filters
    qf = nthash.hash_frames(jnp.asarray(rand_codes(8, c["query_L"],
                                                   c["query_seed"])),
                            c["k"], c["h"])
    r2, h2, raw2 = dist_mibf.at_rank_data(jmesh(p), sm, qf.hashes)
    r1, h1, raw1 = mibf_mod.at_rank_data(m1s, qf.hashes)
    for got, a, b in ((joined(outs, "rank"), r2, r1),
                      (joined(outs, "hit"), h2, h1),
                      (joined(outs, "raw"), raw2, raw1)):
        np.testing.assert_array_equal(got, np.asarray(a))
        np.testing.assert_array_equal(got, np.asarray(b))


def check_saturate(p, out):
    c = cases.M_SATURATE
    size = 8 * 32 * c["nw_per"]
    _, sm = jax_sharded("M_SATURATE", p, size, False)
    smsat = dist_mibf.saturate(jmesh(p), sm, jframes("M_SATURATE")[0].hashes)
    outs = out("mibf_saturate")
    np.testing.assert_array_equal(stacked(outs, "data"),
                                  np.asarray(smsat.data))
    (m1, _), _ = single_build("M_SATURATE", size)
    m1sat = mibf_mod.saturate(m1, jframes("M_SATURATE")[0].hashes)
    np.testing.assert_array_equal(outs[0]["single_data"],
                                  np.asarray(m1sat.data))


RESULT_FIELDS = cases.RESULT_FIELDS


def encode(res) -> np.ndarray:
    """JAX result lists in the layout of ``cases.encode_results``."""
    rows = [[r] + [getattr(q, f) for f in RESULT_FIELDS]
            for r, rs in enumerate(res) for q in rs]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 1 + len(
        RESULT_FIELDS))


def classify_support(m, mesh=None):
    n = cases.M_CLASSIFY["num_ids"]
    kw = dict(per_frame_prob=[0.0] + [0.1] * (n - 1), extra_count=2.0,
              extra_frame_limit=10**6, max_miss=0, min_count=1,
              best_hit_agree=False)
    if mesh is None:
        return mibf_query.MIBFQuerySupport(m=m, **kw)
    return dist_mibf.ShardedMIBFQuerySupport(mesh=mesh, m=m, **kw)


@functools.lru_cache(maxsize=None)
def classify_frames():
    c = cases.M_CLASSIFY
    reads, mates = cases.classify_inputs()
    return (nthash.hash_frames(jnp.asarray(reads), c["k"], c["h"]),
            nthash.hash_frames(jnp.asarray(mates), c["k"], c["h"]))


def classify(qs):
    """(query_many, sat_count, eval_count, query_paired_many) of an
    engine, encoded."""
    n = cases.M_CLASSIFY["num_ids"]
    mc = np.full(n, 1, np.int32)
    qf, qf2 = classify_frames()
    single = encode(qs.query_many(qf.hashes, qf.valid, mc))
    counts = (qs.sat_count, qs.eval_count)
    paired = encode(qs.query_paired_many(qf.hashes, qf.valid, qf2.hashes,
                                         qf2.valid, mc))
    return single, counts, paired


@functools.lru_cache(maxsize=None)
def single_classify():
    c = cases.M_CLASSIFY
    _, (m, _) = single_build("M_CLASSIFY", 8 * 32 * c["nw_per"])
    return classify(classify_support(m))


def check_classify(p, out, single=False):
    """Ranked QueryResults, sat and eval counts of ``mibf_classify``
    against the JAX sharded engine at world size p (and, when ``single``,
    the single-device engine), single reads and pairs."""
    c = cases.M_CLASSIFY
    _, sm = jax_sharded("M_CLASSIFY", p, 8 * 32 * c["nw_per"], True)
    want = classify(classify_support(sm, jmesh(p)))
    outs = out("mibf_classify")
    reads = joined(outs, "single")
    paired = joined(outs, "paired")
    for exp in (want, single_classify()) if single else (want,):
        np.testing.assert_array_equal(reads, exp[0])
        np.testing.assert_array_equal(paired, exp[2])
        for o in outs:
            assert (int(o["sat_count"]), int(o["eval_count"])) == exp[1]
    assert len(reads) and len(paired)    # reads classify to something
