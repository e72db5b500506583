"""Kernel times of one source tree of the port, for comparing two trees
(a parent commit and a change) on one GPU in one call.

    python btl_bloomfilter_tpu_torch/tools/time_kernels.py [--tree DIR]
        [--label NAME] [--kernels nthash_scan,mibf_frame_scan,dma_sweep]

Imports ``btl_bloomfilter_tpu_torch`` from DIR (default: the tree this file
is in), builds its kernels, and prints one JSON line with the card, the
label and the milliseconds a call of each chosen kernel, timed by
``tools/timing.py`` as chip_smoke.py times: as the host issues the calls
(key ``name``) and with the calls queued, the card's own time (key ``name
queued``). The kernels it can time (``CALLS``):

  * ``nthash_scan``: positions at chip_smoke.py's phase-2 shape (512 x 2048
    reads with 2% N, k=31, h=4, size 2**30);
  * ``mibf_frame_scan``: pass C on the inputs bench.py's MIBF config gives
    it (``tools/profile_mibf.py``: 256 reads x 2048 bases, 2018 frames of 4
    slots);
  * ``dma_sweep``: each copy sweep of ``probes/partition_probe.py``, and
    ``copy_`` of the same tensor beside it.

Run it with the parent's tree and the change's in turns (parent, change,
change, parent) to compare the two on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_timing():
    """This tree's ``tools/timing.py``, loaded by path: the package is
    imported from --tree, which may be an older tree without it."""
    spec = importlib.util.spec_from_file_location(
        "_btl_time_kernels_timing", os.path.join(HERE, "timing.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses looks the module up
    spec.loader.exec_module(mod)
    return mod


def hash_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(512, 2048), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes = torch.from_numpy(codes).to(dev)
    return {"nthash_scan": lambda: nthash_scan.positions_planes(
        codes, 31, 4, 1 << 30)}


def frame_scan_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.kernels import mibf_frame_scan
    from btl_bloomfilter_tpu_torch.tools import profile_mibf as mb

    refs, reads, _ = mb.bench_inputs()
    m, _ = mb.bench_build(torch.from_numpy(refs).to(dev),
                          torch.arange(1, mb.IDS, device=dev))
    qhashes, qvalid = mb.bench_hashes(torch.from_numpy(reads).to(dev))
    calls, scan = [], mibf_frame_scan.frame_scan

    def recorded(*a):
        calls.append(a)
        return scan(*a)

    mibf_frame_scan.frame_scan = recorded
    try:
        mb.bench_engine(m).query_many(qhashes, qvalid, mb.MIN_COUNT)
    finally:
        mibf_frame_scan.frame_scan = scan
    fargs = calls[0]
    return {"mibf_frame_scan": lambda: scan(*fargs)}


def sweep_calls(dev) -> dict:
    from btl_bloomfilter_tpu_torch.probes import partition_probe

    out = {}
    for k, rows in partition_probe.SWEEPS:
        copy, src = partition_probe.dma_sweep(partition_probe.NSTEPS, k,
                                              rows, device=dev)
        dst = torch.empty_like(src)
        out[f"dma_sweep {k}x{rows}"] = lambda c=copy, s=src: c(s)
        out[f"copy_ {k}x{rows}"] = lambda d=dst, s=src: d.copy_(s)
    return out


# kernel name -> the calls that time it, {label: call}
CALLS = {"nthash_scan": hash_calls, "mibf_frame_scan": frame_scan_calls,
         "dma_sweep": sweep_calls}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(CALLS),
                    help="comma-separated, of: " + ", ".join(CALLS))
    args = ap.parse_args(argv)
    names = args.kernels.split(",")
    unknown = [n for n in names if n not in CALLS]
    if unknown:
        ap.error(f"no timing for {unknown}; known: {list(CALLS)}")
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA GPU")
    timing = load_timing()
    sys.path.insert(0, os.path.abspath(args.tree))
    from btl_bloomfilter_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    out = {"label": args.label, "tree": args.tree, "card": card}
    torch.cuda._sleep(timing.QUEUE_CYCLES * 20)  # the card at its clocks
    for name in names:
        for label, fn in CALLS[name](dev).items():
            t = timing.kernel_times(fn)
            out[label], out[label + " queued"] = t.issued, t.card
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
