"""The control of ``correct`` for the counting cells: every valid frame of
a batch through one closed-form conservative step at once, with no replay
(each counter max(cur, min + 1) below 255, frames that share a counter
resolved by the larger value). It is the shortcut a later speed-up would be
tempted by, and it breaks the configuration's guarantee of stream-order
incrementMin (a k-mer seen twice in a batch counts once), so the cell's
check has to come out not correct.

On the card, at the cell's own size, several seeds in one process:

    python3 portbench/control_counting.py --workload wbcel235.count.reads30x --seeds 11 12 13

One JSON line a seed, with each number compared and its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402
from portbench.reference import counting as ref_counting  # noqa: E402
from portbench.reference import nthash  # noqa: E402


class NoReplayApi:
    """``create`` / ``insert_seq`` of the port's ``counting`` module, the
    insert computed as one closed-form step over every frame."""

    def create(self, size_in_bytes, hash_num, kmer_size, count_threshold,
               counter_width=1, *, device="cuda"):
        del count_threshold
        if counter_width != 1:
            raise ValueError("the control counts one-byte counters")
        return types.SimpleNamespace(
            counters=torch.zeros(size_in_bytes // 4, dtype=torch.int32,
                                 device=device),
            size=size_in_bytes, hash_num=hash_num, kmer_size=kmer_size)

    def insert_seq(self, cbf, codes):
        codes = torch.as_tensor(codes).to(cbf.counters.device)
        pos, valid = nthash.positions(codes, cbf.kmer_size, cbf.hash_num,
                                      cbf.size)
        frames = pos.reshape(cbf.hash_num, -1)[:, valid.reshape(-1)].T
        counts = cbf.counters.view(torch.uint8)
        cur = counts[frames].to(torch.int16)
        low = cur.amin(dim=1, keepdim=True)
        new = torch.maximum(cur, (low + 1).clamp(
            max=ref_counting.COUNTER_MAX))
        out = counts.to(torch.int16).scatter_reduce_(
            0, frames.reshape(-1), new.reshape(-1), "amax")
        counts.copy_(out.to(torch.uint8))
        return cbf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = run.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    e2e, layer = run.cell_metrics(bench, cell["name"])
    for seed in args.seeds:
        result = run.run(run.load_config(bench, cell["config"]),
                         run.load_mix(cell["traffic"]), e2e, layer,
                         seed=seed, seconds=args.seconds, traced=False,
                         device=torch.device("cuda", 0),
                         api=NoReplayApi(), t_start=run.time.perf_counter())
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": "one closed-form step, no replay",
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
