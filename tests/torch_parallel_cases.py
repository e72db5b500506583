"""Rank-side cases of the port's distribution-layer tests.

Each case is called on every rank of a ``tools/dist_run.py`` launch as
``case(mesh)`` and returns numpy outputs; the tests hold them against the
JAX package's ``parallel`` functions (or, past 2**32 bits and counters,
against Python models) on the same inputs, which the helpers here make
from numpy seeds in the test process too. This module imports torch and
the port only: the rank processes never import JAX.
"""

import numpy as np
import torch

from btl_bloomfilter_tpu_torch.models import counting
from btl_bloomfilter_tpu_torch.ops import nthash, u64
from btl_bloomfilter_tpu_torch.parallel import (collectives, dist_bloom,
                                                dist_counting, dist_mibf)
from btl_bloomfilter_tpu_torch.parallel import mesh as mesh_lib


def rand_codes(b, l, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(b, l), dtype=np.uint8)


def frames(codes, k, h):
    """(hashes int64 [B, W, h], valid bool [B, W]) of codes on the CPU."""
    f = nthash.hash_frames(torch.from_numpy(np.asarray(codes)), k, h)
    return f.hashes, f.valid


def local(mesh, x):
    return mesh_lib.sharded(mesh, x)


def npy(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (``.cpu().numpy()`` of a CPU tensor shares its
    memory, which a later in-place update would change)."""
    return t.cpu().numpy().copy()


def u32(t: torch.Tensor) -> np.ndarray:
    return npy(t).view(np.uint32)


def unsigned(t: torch.Tensor) -> np.ndarray:
    """A copy viewed as the unsigned type of its width (the port keeps
    uint16 / uint32 IDs as int16 / int32 bit patterns)."""
    a = npy(t)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


# ---------------------------------------------------------------------------
# inputs (shared with the tests)
# ---------------------------------------------------------------------------

def or_inputs(p, width, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(p, width), dtype=np.uint32)


# (rows, length, seed, k, h, size) a case; a world of 3 takes rows and sizes
# it divides
DP_BLOOM = {"rows": 16, "rows3": 12, "L": 60, "seed": 3, "k": 11, "h": 3,
            "size": 8192}
SHARDED_BLOOM = dict(rows=16, L=60, seed=4, k=11, h=3, size=8 * 32 * 64)
OVERFLOW = {"rows": 8, "rows3": 9, "L": 40, "seed": 5, "k": 5, "h": 4,
            "size": 8 * 32 * 8, "size3": 3 * 32 * 24}
DP_COUNTING = dict(rows=16, L=50, seed=8, k=9, h=3, nbytes=256)
MULTIHOST = dict(rows=8, L=64, seed=5, k=9, h=3, size=4096)


def rows_size(cfg, p):
    """(rows, size) of a case at world size p."""
    if p == 3:
        return cfg["rows3"], cfg.get("size3", cfg.get("size"))
    return cfg["rows"], cfg.get("size")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def or_butterfly(mesh):
    x = or_inputs(mesh.size, 64, 1)[mesh.rank]
    t = torch.from_numpy(x.view(np.int32).copy()).to(mesh.device)
    return {"out": u32(collectives.or_allreduce_butterfly(t, mesh))}


def or_rsag(mesh):
    x = or_inputs(mesh.size, 128, 2)[mesh.rank]
    t = torch.from_numpy(x.view(np.int32).copy()).to(mesh.device)
    return {"out": u32(collectives.or_allreduce_rsag(t, mesh))}


def or_rsag_odd(mesh):
    """A length the world does not divide: the butterfly fallback."""
    x = or_inputs(mesh.size, 130, 6)[mesh.rank]
    t = torch.from_numpy(x.view(np.int32).copy()).to(mesh.device)
    return {"out": u32(collectives.or_allreduce_rsag(t, mesh))}


def saturating_add(mesh):
    x = torch.full((16,), 40, dtype=torch.int32, device=mesh.device)
    u8 = torch.full((16,), 200, dtype=torch.uint8, device=mesh.device)
    return {"out": u32(collectives.saturating_add_allreduce(x, 255, mesh)),
            "u8": npy(collectives.saturating_add_allreduce(
                u8, 255, mesh))}


# ---------------------------------------------------------------------------
# Bloom
# ---------------------------------------------------------------------------

def dp_bloom(mesh):
    from btl_bloomfilter_tpu_torch.models import bloom
    c = DP_BLOOM
    rows, size = rows_size(c, mesh.size)
    codes = local(mesh, rand_codes(rows, c["L"], c["seed"]))
    bf = bloom.create(size, c["h"], c["k"], device=mesh.device)
    dist_bloom.dp_insert_seq(mesh, bf, codes)
    hits, valid = dist_bloom.dp_contains_seq(mesh, bf, codes)
    return {"words": u32(bf.words), "hits": npy(hits),
            "valid": npy(valid)}


def _sharded(mesh, c, cap=None):
    rows, size = rows_size(c, mesh.size)
    hashes, valid = frames(rand_codes(rows, c["L"], c["seed"]), c["k"],
                           c["h"])
    hashes, valid = local(mesh, hashes), local(mesh, valid)
    sbf = dist_bloom.create_sharded(mesh, size, c["h"], c["k"])
    sbf, rerouted = dist_bloom.sharded_insert_frames(mesh, sbf, hashes,
                                                     valid, cap=cap)
    got = dist_bloom.sharded_contains_frames(mesh, sbf, hashes, cap=cap)
    return {"words": u32(sbf.words), "rerouted": rerouted,
            "hits": npy(got), "valid": npy(valid)}


def sharded_bloom(mesh):
    return _sharded(mesh, SHARDED_BLOOM)


def sharded_overflow(mesh):
    return _sharded(mesh, OVERFLOW, cap=2)


def dp_counting(mesh):
    c = DP_COUNTING
    codes = local(mesh, rand_codes(c["rows"], c["L"], c["seed"]))
    cbf = counting.create(c["nbytes"], c["h"], c["k"], 1, 1,
                          device=mesh.device)
    dist_counting.dp_insert_all_seq(mesh, cbf, codes)
    hits, valid = dist_counting.dp_contains_seq(mesh, cbf, codes)
    return {"counters": counting.to_numpy(cbf), "hits": npy(hits),
            "valid": npy(valid)}


def multihost_dp(mesh):
    """The two-process data-parallel build: every inserted window found."""
    from btl_bloomfilter_tpu_torch.models import bloom
    c = MULTIHOST
    codes = local(mesh, rand_codes(c["rows"], c["L"], c["seed"]))
    bf = bloom.create(c["size"], c["h"], c["k"], device=mesh.device)
    dist_bloom.dp_insert_seq(mesh, bf, codes)
    hits, valid = dist_bloom.dp_contains_seq(mesh, bf, codes)
    if not bool((hits == valid).all()):
        raise AssertionError("an inserted window was not found")
    return {"words": u32(bf.words)}


BLOOM_CASES = ["or_butterfly", "or_rsag", "or_rsag_odd", "saturating_add",
               "dp_bloom", "sharded_bloom", "sharded_overflow",
               "dp_counting"]
BLOOM_CASES3 = ["or_butterfly", "or_rsag", "or_rsag_odd", "saturating_add",
                "dp_bloom", "sharded_overflow"]


# ---------------------------------------------------------------------------
# the launch (test side)
# ---------------------------------------------------------------------------

def run_cases(out_dir, cases, world: int):
    """Run ``cases`` of this module on ``world`` gloo ranks on the CPU;
    returns a function of a case's name giving its per-rank outputs. A
    rank that hangs in a collective fails after the group's 60 s
    timeout; the launch as a whole is cut at 240 s."""
    import os

    from btl_bloomfilter_tpu_torch.tools import dist_run
    dist_run.launch(os.path.abspath(__file__), cases, world, str(out_dir),
                    device="cpu", timeout=60, limit=240)
    return lambda name: dist_run.load(str(out_dir), name, world)


def joined(outs, key):
    """A per-rank output joined in rank order along axis 0."""
    return np.concatenate([o[key] for o in outs])


# ---------------------------------------------------------------------------
# sharded counting filter
# ---------------------------------------------------------------------------

# (rows, length, seed, k, h, size in bytes, width) a case
C_INSERT_ALL = dict(rows=16, L=50, seed=31, k=9, h=3, nbytes=256, width=1)
C_HEAVY_ALL = dict(rows=64, L=140, seed=32, k=5, h=4, nbytes=64, width=1)
C_CONSERVATIVE = dict(rows=16, L=50, seed=33, k=9, h=3, nbytes=256, width=1)
C_ENTANGLED = dict(rows=16, L=40, seed=34, k=5, h=4, nbytes=64, width=1)
C_WIDTH8 = dict(rows=16, L=60, seed=71, k=7, h=3, nbytes=512, width=8)


def _counting(mesh, c):
    hashes, valid = frames(rand_codes(c["rows"], c["L"], c["seed"]), c["k"],
                           c["h"])
    scbf = dist_counting.create_sharded(mesh, c["nbytes"], c["h"], c["k"], 1,
                                        counter_width=c["width"])
    return scbf, local(mesh, hashes), local(mesh, valid)


def shard_counters(scbf) -> np.ndarray:
    """This rank's counters, one a counter (uint8/16/32/64)."""
    return counting.to_numpy(scbf.shard())


def _queries(mesh, scbf, hashes, cap=None):
    return {"min_count": u64.to_numpy(dist_counting.sharded_min_count(
                mesh, scbf, hashes, cap)),
            "contains": npy(dist_counting.sharded_contains(
                mesh, scbf, hashes, cap))}


def counting_insert_all(mesh):
    out = {}
    for cap in (None, 2):
        scbf, hashes, valid = _counting(mesh, C_INSERT_ALL)
        dist_counting.sharded_insert_all(mesh, scbf, hashes, valid, cap=cap)
        q = _queries(mesh, scbf, hashes, cap)
        out.update({f"counters_{cap}": shard_counters(scbf),
                    f"min_count_{cap}": q["min_count"],
                    f"contains_{cap}": q["contains"]})
    return out


def counting_heavy_all(mesh):
    scbf, hashes, valid = _counting(mesh, C_HEAVY_ALL)
    dist_counting.sharded_insert_all(mesh, scbf, hashes, valid, cap=2)
    return {"counters": shard_counters(scbf)}


def counting_conservative(mesh):
    scbf, hashes, valid = _counting(mesh, C_CONSERVATIVE)
    dist_counting.sharded_insert(mesh, scbf, hashes, valid)
    return {"counters": shard_counters(scbf)}


def counting_entangled(mesh):
    out = {}
    for cap in (None, 4):
        scbf, hashes, valid = _counting(mesh, C_ENTANGLED)
        dist_counting.sharded_insert(mesh, scbf, hashes, valid,
                                     max_entangled=cap)
        out[f"counters_{cap}"] = shard_counters(scbf)
    return out


def counting_width8(mesh):
    scbf, hashes, valid = _counting(mesh, C_WIDTH8)
    dist_counting.sharded_insert(mesh, scbf, hashes, valid)
    out = {"conservative": shard_counters(scbf)}
    dist_counting.sharded_insert_all(mesh, scbf, hashes, valid)
    out["all"] = shard_counters(scbf)
    out.update(_queries(mesh, scbf, hashes))
    return out


COUNTING_CASES = ["counting_insert_all", "counting_heavy_all",
                  "counting_conservative", "counting_entangled",
                  "counting_width8"]


# ---------------------------------------------------------------------------
# sharded MIBF
# ---------------------------------------------------------------------------

M_BUILD = dict(k=9, h=3, rows=8, L=40, seeds=(20, 21, 22), query_seed=99,
               query_L=30)
M_SATURATE = dict(k=7, h=3, rows=8, L=30, seeds=(40, 41), nw_per=32)
M_CLASSIFY = dict(k=9, h=3, rows=8, L=40, seeds=(50, 51, 52), nw_per=64,
                  num_ids=5)


def mibf_seqs(c):
    return [rand_codes(c["rows"], c["L"], seed=s) for s in c["seeds"]]


def _mibf_build(mesh, c, size, saturate=True, out=None):
    """The sharded build of a case's sequences: phase 1 from each rank's
    rows, phase 3 from every sequence whole, phase 4 from each rank's rows
    (when ``saturate``). ``out`` gathers the state after each phase."""
    fr = [frames(s, c["k"], c["h"]) for s in mibf_seqs(c)]
    bvw = torch.zeros(size // mesh.size // 32, dtype=torch.int32,
                      device=mesh.device)
    for hs, v in fr:
        dist_mibf.insert_bv(mesh, bvw, size, local(mesh, hs), local(mesh, v))
    sm = dist_mibf.freeze(mesh, bvw, size, c["h"], c["k"], data_width=2)
    for i, (hs, v) in enumerate(fr):
        dist_mibf.insert_mibf(mesh, sm, hs.to(mesh.device), i + 1,
                              v.to(mesh.device))
    if out is not None:
        g, gc = dist_mibf.to_single(mesh, sm)
        out.update(bv=u32(sm.bv_words), cum=u32(sm.cum_ranks),
                   rank_base=npy(sm.rank_base),
                   d_sizes=np.asarray(sm.d_sizes), d_size=sm.d_size,
                   data3=unsigned(sm.data), counts3=unsigned(sm.counts),
                   single_data3=unsigned(g.data),
                   single_counts3=unsigned(gc))
    if saturate:
        for i, (hs, v) in enumerate(fr):
            dist_mibf.insert_saturation(mesh, sm, local(mesh, hs), i + 1,
                                        local(mesh, v))
    return sm, fr


def mibf_build(mesh, nw_per):
    c = M_BUILD
    out = {}
    sm, _ = _mibf_build(mesh, c, 8 * 32 * nw_per, out=out)
    g, gc = dist_mibf.to_single(mesh, sm)
    out.update(data4=unsigned(sm.data), counts4=unsigned(sm.counts),
               single_data4=unsigned(g.data),
               single_counts4=unsigned(gc))
    qh, _ = frames(rand_codes(8, c["query_L"], c["query_seed"]), c["k"],
                   c["h"])
    rank, hit, raw = dist_mibf.at_rank_data(mesh, sm, local(mesh, qh))
    out.update(rank=npy(rank), hit=npy(hit),
               raw=u64.to_numpy(raw))
    return out


def mibf_build_64(mesh):
    return mibf_build(mesh, 64)


def mibf_build_37(mesh):
    """37 words a shard of 8: a shard count no power of two divides."""
    return mibf_build(mesh, 37)


def mibf_saturate(mesh):
    c = M_SATURATE
    sm, fr = _mibf_build(mesh, c, 8 * 32 * c["nw_per"], saturate=False)
    dist_mibf.saturate(mesh, sm, local(mesh, fr[0][0]))
    g, _ = dist_mibf.to_single(mesh, sm)
    return {"data": unsigned(sm.data),
            "single_data": unsigned(g.data)}


def classify_inputs():
    """(reads, mates) codes of the classification case: 8 reads (4 random,
    2 from each of sequences 1 and 2) and their mates of 30 bases."""
    c = M_CLASSIFY
    seqs = mibf_seqs(c)
    reads = np.concatenate([rand_codes(4, 40, seed=60), seqs[1][:2],
                            seqs[2][:2]])
    mates = np.concatenate([rand_codes(4, 30, seed=61), seqs[1][2:4, :30],
                            seqs[2][2:4, :30]])
    return reads, mates


RESULT_FIELDS = ("id", "count", "non_sat_count", "total_count",
                 "total_non_sat_count", "non_sat_frame_count", "solid_count")


def encode_results(res, first: int) -> np.ndarray:
    """Result lists -> int64 [n, 1 + 7]: the read's index, then the
    fields the tests compare, in ranked order."""
    rows = [[first + r] + [getattr(q, f) for f in RESULT_FIELDS]
            for r, rs in enumerate(res) for q in rs]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 1 + len(
        RESULT_FIELDS))


def mibf_classify(mesh):
    c = M_CLASSIFY
    sm, _ = _mibf_build(mesh, c, 8 * 32 * c["nw_per"])
    n = c["num_ids"]
    qs = dist_mibf.ShardedMIBFQuerySupport(
        mesh=mesh, m=sm, per_frame_prob=[0.0] + [0.1] * (n - 1),
        extra_count=2.0, extra_frame_limit=10**6, max_miss=0, min_count=1,
        best_hit_agree=False)
    mc = np.full(n, 1, np.int32)
    reads, mates = classify_inputs()
    h1, v1 = frames(reads, c["k"], c["h"])
    h2, v2 = frames(mates, c["k"], c["h"])
    first = mesh_lib.block(mesh, reads.shape[0]).start
    h1, v1, h2, v2 = (local(mesh, x) for x in (h1, v1, h2, v2))
    res = qs.query_many(h1, v1, mc)
    out = {"single": encode_results(res, first),
           "sat_count": qs.sat_count, "eval_count": qs.eval_count}
    out["paired"] = encode_results(qs.query_paired_many(h1, v1, h2, v2, mc),
                                   first)
    return out


MIBF_CASES = ["mibf_build_64", "mibf_build_37", "mibf_saturate"]


# ---------------------------------------------------------------------------
# past 2**32 bits and counters (held against Python models)
# ---------------------------------------------------------------------------

W_BLOOM = dict(size=(1 << 32) + 256 * 32, h=3, k=5, n=256, seed=33,
               probes=64)
W_COUNTING = dict(nbytes=(1 << 32) + 64, h=2, k=5, n=64, seed=44)
W_MIBF = dict(size=(1 << 32) + 2048, h=3, k=11, n=160, seed=55, id=6,
              probes=32)


def wide_values(c, size, repeat=0):
    """(values uint64 [n, h], rng): half below 2**32, half above, the
    first ``repeat`` frames repeated at n/2, as the JAX tests draw them."""
    rng = np.random.default_rng(c["seed"])
    n, h = c["n"], c["h"]
    vals = np.concatenate([
        rng.integers(0, 1 << 32, size=(n // 2, h), dtype=np.uint64),
        rng.integers(1 << 32, size, size=(n // 2, h), dtype=np.uint64)])
    vals[n // 2: n // 2 + repeat] = vals[:repeat]
    return vals, rng


def sparse(words: torch.Tensor):
    """(indices int64, values) of the non-zero elements of a shard."""
    idx = torch.nonzero(words).reshape(-1)
    return npy(idx), npy(words[idx])


def bloom_wide(mesh):
    c = W_BLOOM
    vals, rng = wide_values(c, c["size"])
    hashes = local(mesh, u64.from_numpy(vals.reshape(c["n"], 1, c["h"])))
    sbf = dist_bloom.create_sharded(mesh, c["size"], c["h"], c["k"])
    sbf, rerouted = dist_bloom.sharded_insert_frames(
        mesh, sbf, hashes, torch.ones(hashes.shape[:-1], dtype=torch.bool))
    got = dist_bloom.sharded_contains_frames(mesh, sbf, hashes)
    probes = rng.integers(0, c["size"], size=(c["probes"], c["h"]),
                          dtype=np.uint64)
    got2 = dist_bloom.sharded_contains_frames(mesh, sbf, local(
        mesh, u64.from_numpy(probes.reshape(-1, 1, c["h"]))))
    idx, w = sparse(sbf.words)
    return {"idx": idx, "words": w.view(np.uint32), "hits": npy(got),
            "probe_hits": npy(got2), "rerouted": rerouted,
            "words_per_shard": sbf.words.numel()}


def counting_wide(mesh):
    c = W_COUNTING
    scbf = dist_counting.create_sharded(mesh, c["nbytes"], c["h"], c["k"],
                                        1, 1)
    vals, _ = wide_values(c, scbf.size, repeat=8)
    hashes = local(mesh, u64.from_numpy(vals.reshape(c["n"], 1, c["h"])))
    dist_counting.sharded_insert(mesh, scbf, hashes)
    out = {}
    out["idx"], out["words"] = sparse(scbf.counters)
    out["min_count"] = npy(dist_counting.sharded_min_count(mesh, scbf,
                                                           hashes))
    dist_counting.sharded_insert_all(mesh, scbf, hashes)
    out["idx_all"], out["words_all"] = sparse(scbf.counters)
    out["size"], out["shard_size"] = scbf.size, scbf.shard_size
    return out


def mibf_wide(mesh):
    c = W_MIBF
    vals, rng = wide_values(c, c["size"], repeat=4)
    hashes = u64.from_numpy(vals.reshape(c["n"], 1, c["h"]))
    bvw = torch.zeros(c["size"] // mesh.size // 32, dtype=torch.int32,
                      device=mesh.device)
    dist_mibf.insert_bv(mesh, bvw, c["size"], local(mesh, hashes))
    m = dist_mibf.freeze(mesh, bvw, c["size"], c["h"], c["k"])
    dist_mibf.insert_mibf(mesh, m, hashes.to(mesh.device), c["id"])
    rank, hit, raw = dist_mibf.at_rank_data(mesh, m, local(mesh, hashes))
    probes = rng.integers(0, c["size"], size=(c["probes"], c["h"]),
                          dtype=np.uint64)
    _, hit2, _ = dist_mibf.at_rank_data(mesh, m, local(
        mesh, u64.from_numpy(probes.reshape(-1, 1, c["h"]))))
    return {"d_size": m.d_size, "rank": npy(rank), "hit": npy(hit),
            "raw": u64.to_numpy(raw).copy(), "probe_hit": npy(hit2)}


WIDE_CASES = ["bloom_wide", "counting_wide", "mibf_wide"]


def unmatched_collective(mesh):
    """Rank 0 enters a sum that the other ranks never join: the process
    group's timeout must end it."""
    if mesh.rank == 0:
        collectives.all_sum(torch.zeros(1, dtype=torch.int64), mesh)
    return {}


def hangs(mesh):
    """A rank that never returns and enters no collective: only the
    launcher's own time limit ends it."""
    import time
    time.sleep(3600)
    return {}
