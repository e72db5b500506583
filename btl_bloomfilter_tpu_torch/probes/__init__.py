"""Probes: the ports of the JAX package's kernel probes under ``bench/``,
one module each, printing the same lines.

  * ``ring_probe``      - the Bloom insert step through the sorted scatters
  * ``vmem_sort_probe`` - the 2048-key block sort against a full sort
  * ``partition_probe`` - the 1024-key chunk sort and the copy sweep
  * ``kernel_lab``      - the static-window scatter in shared memory

Each runs with ``python -m btl_bloomfilter_tpu_torch.probes.<name>``, on
the card by default, and on the kernels' plain versions with ``--device
cpu``. Each ``main`` also returns what it measured.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import u64


def parser(doc: str, reps: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")
    p.add_argument("--reps", type=int, default=reps,
                   help="timed calls after the first")
    return p


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def first_call(fn, device):
    """(result, seconds) of one call, synchronised."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def time_ms(fn, reps: int, device) -> float:
    """Milliseconds per call over ``reps`` back-to-back calls: CUDA events
    on a GPU, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def popcount(words: torch.Tensor) -> int:
    return int(u64.popcount32(words.reshape(-1)).sum())


def blocks_sorted(x: torch.Tensor, block: int) -> bool:
    """Each consecutive block of x (int32 holding uint32 bits) ascends in
    unsigned order."""
    u = u64.from_u32_bits(x.reshape(-1, block))
    return bool((u[:, 1:] >= u[:, :-1]).all())
