"""Where the time of the MIBF build and classification goes on a GPU.

At bench.py's pinned MIBF configuration (k=31, h=4, 2**28-bit vector, 63
references x 16,384 bases from seed 3, width-2 IDs; 256 reads x 2048 bases
classified with min count 2 and frame probability 0.1), prints:

  * each stage's time on the host clock around ``torch.cuda.synchronize()``
    (mean of ``--steps`` runs after a warm-up): hash, phase 1, freeze,
    phase 3, phase 4; and for classification the rank + ID lookups, the
    engine (passes A-C and the tables) and the host-side ranking;
  * under ``torch.profiler`` over ``--steps`` whole builds and
    classifications: the device busy time per step (the CUDA kernel rows
    only), the idle share of the step, and the largest kernels;

and writes the same as one JSON object to ``--out``.

    python -m btl_bloomfilter_tpu_torch.tools.profile_mibf --out mibf_profile.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..kernels import nthash_scan
from ..models import mibf_construct, mibf_query

# bench.py's pinned MIBF configuration (bench.py:260-267, 333-337); chip_smoke.py
# phase 7 builds the same through the functions below
K, H = 31, 4
BV, IDS, REF_L = 1 << 28, 64, 16384
R, L = 256, 2048
DATA_WIDTH = 2
SEED = 3
PER_FRAME_PROB = [0.0] + [0.1] * (IDS - 1)
MIN_COUNT = np.full(IDS, 2, np.int32)


def reads_from(refs: np.ndarray, rows: int, length: int, rng):
    """rows reads of ``length`` bases cut from random references at random
    offsets, and the index of each one's source."""
    srcs = rng.integers(0, refs.shape[0], size=rows)
    starts = rng.integers(0, refs.shape[1] - length, size=rows)
    return np.stack([refs[s, o: o + length]
                     for s, o in zip(srcs, starts)]), srcs


def bench_inputs():
    """The references uint8 [IDS - 1, REF_L] (IDs 1..IDS-1), the reads
    uint8 [R, L] cut from them, and each read's source index, from SEED."""
    rng = np.random.default_rng(SEED)
    refs = rng.integers(0, 4, size=(IDS - 1, REF_L), dtype=np.uint8)
    reads, srcs = reads_from(refs, R, L, rng)
    return refs, reads, srcs


def bench_hashes(codes: torch.Tensor):
    """Hash frames int64 [..., W, H] and valid [..., W] of codes."""
    planes, _s, valid = nthash_scan.hash_frames_planes(codes, K, H)
    return planes.movedim(0, -1), valid


def build_stages(codes: torch.Tensor, ids: torch.Tensor, st: dict):
    """bench.py's full build of the references ``codes`` with ``ids`` as
    (name, fn) stages run in order: hash, phase 1, freeze, phases 3 and 4.
    They leave the filter and its counts in st["m"], st["c"]."""

    def hash_refs():
        st["h"], st["v"] = bench_hashes(codes)

    def phase1():
        st["bv"] = mibf_construct.BitVectorState(
            bv_words=torch.zeros(BV // 32, dtype=torch.int32,
                                 device=codes.device),
            filter_size=BV, kmer_size=K, hash_num=H, occupancy=0.5,
            sseeds=())
        mibf_construct.insert_bv(st["bv"], st["h"], st["v"])

    def freeze():
        st["m"], st["c"] = mibf_construct.get_empty_mibf(st["bv"],
                                                         DATA_WIDTH)

    def phase3():
        mibf_construct.insert_mibf_many(st["m"], st["c"], st["h"], ids,
                                        st["v"])

    def phase4():
        mibf_construct.insert_saturation_many(st["m"], st["c"], st["h"], ids,
                                              st["v"])

    return [("hash", hash_refs), ("phase 1", phase1), ("freeze", freeze),
            ("phase 3", phase3), ("phase 4", phase4)]


def bench_build(codes: torch.Tensor, ids: torch.Tensor):
    """The whole build of :func:`build_stages`; returns (m, counts)."""
    st = {}
    for _, fn in build_stages(codes, ids, st):
        fn()
    return st["m"], st["c"]


def bench_engine(m) -> mibf_query.MIBFQuerySupport:
    """bench.py's classifier over m."""
    return mibf_query.MIBFQuerySupport(
        m=m, per_frame_prob=PER_FRAME_PROB, extra_count=2.0,
        extra_frame_limit=10**6, max_miss=0, min_count=1,
        best_hit_agree=False)


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def stage_times(stages, steps: int):
    """Mean host ms of each (name, fn) stage run in order, ``steps`` times,
    each ended by a synchronize; a warm-up pass first."""
    total = {name: 0.0 for name, _ in stages}
    for rep in range(steps + 1):
        for name, fn in stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep:
                total[name] += (time.perf_counter() - t0) * 1e3
    return {name: t / steps for name, t in total.items()}


def profile(fn, steps: int):
    """(device busy ms per step, wall ms per step, top kernels) of fn under
    torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
    return busy, wall, [(e.key[:90], e.self_device_time_total / 1e3 / steps,
                         e.count // steps) for e in top]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_mibf needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = _card()

    refs, reads, _srcs = bench_inputs()
    codes = torch.from_numpy(refs).to(dev)
    ids = torch.arange(1, IDS, device=dev)
    qcodes = torch.from_numpy(reads).to(dev)
    st = {}
    build = build_stages(codes, ids, st)
    build_ms = stage_times(build, args.steps)
    qh, qv = bench_hashes(qcodes)
    m = st["m"]

    def lookups():
        st["q"] = mibf_query.prep_frames(m, qh, qv, 0)

    def engine():
        raw, hit, usable, misses = st["q"]
        out = mibf_query.query_frames_batch(m, raw, hit, usable, misses,
                                            MIN_COUNT, IDS, 10**6,
                                            frame_eval=qv)
        st["out"] = {k: v.cpu().numpy() for k, v in out.items()}

    def ranking():
        out = st["out"]
        [mibf_query.summarize(out["counts"][r], out["candidates"][r],
                              out["best"][r], PER_FRAME_PROB, 1, 2.0, False)
         for r in range(R)]

    classify = [("rank + ID lookups", lookups), ("engine", engine),
                ("host ranking", ranking)]
    classify_ms = stage_times(classify, args.steps)

    def whole_build():
        for _, fn in build:
            fn()

    qs = bench_engine(m)
    report = {"card": card, "steps": args.steps,
              "build_stages_ms": build_ms,
              "classify_stages_ms": classify_ms}
    for name, fn in (("build", whole_build),
                     ("classify", lambda: qs.query_many(qh, qv, MIN_COUNT))):
        busy, wall, top = profile(fn, args.steps)
        report[name] = {"device_busy_ms": busy, "wall_ms": wall,
                        "idle_share": 1 - busy / wall, "top_kernels": top}
    print(f"card: {card}")
    for group in ("build_stages_ms", "classify_stages_ms"):
        for name, t in report[group].items():
            print(f"{group[:-10]} {name}: {t:.4f} ms")
    for name in ("build", "classify"):
        r = report[name]
        print(f"{name}: device busy {r['device_busy_ms']:.4f} ms of "
              f"{r['wall_ms']:.4f} ms, idle share {r['idle_share']:.4f}")
        for key, t, n in r["top_kernels"]:
            print(f"    {t:9.4f} ms  x{n:<6d} {key}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
