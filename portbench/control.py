"""The control of ``correct``: the reference put in the port's place with
each hash cut to its low 32 bits before the modulo, the step down in
precision a later change would be tempted by (32-bit positions). It breaks
the configurations' guarantee that a filter's bits are writeBloom's, so
every check of ``run.py`` has to come out not correct.

On the card, at a cell's own size, several seeds in one process:

    python3 portbench/control.py --workload grch38.build --seeds 11 12 13 --seconds 3

One JSON line a seed, with each number compared and its limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402
from portbench.reference import nthash  # noqa: E402


class ControlApi:
    """``insert_seq`` / ``contains_seq`` of the port's ``kmer_bloom`` on
    its filter object, computed by the reference at ``hash_bits``."""

    def __init__(self, hash_bits: int = 32):
        self.hash_bits = hash_bits

    def _positions(self, bf, codes):
        codes = torch.as_tensor(codes).to(bf.words.device)
        return nthash.positions(codes, bf.kmer_size, bf.hash_num, bf.size,
                                self.hash_bits)

    def insert_seq(self, bf, codes):
        pos, valid = self._positions(bf, codes)
        p = torch.unique(pos[:, valid])
        words, inv = torch.unique_consecutive(p >> 5, return_inverse=True)
        delta = torch.zeros(words.numel(), dtype=torch.int64,
                            device=p.device).index_add_(0, inv,
                                                        1 << (p & 31))
        delta = torch.where(delta >= 1 << 31, delta - (1 << 32), delta)
        bf.words[words] |= delta.to(torch.int32)
        return bf

    def contains_seq(self, bf, codes):
        pos, valid = self._positions(bf, codes)
        bits = (bf.words[pos >> 5].to(torch.int64) >> (pos & 31)) & 1
        return (bits == 1).all(dim=0) & valid, valid


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
                         api=ControlApi(), t_start=run.time.perf_counter())
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": "hash_bits=32",
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
