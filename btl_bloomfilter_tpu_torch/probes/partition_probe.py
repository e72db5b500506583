"""The two primitives of any grouping alternative to one flat sort, and the
flat sort itself; the port of ``bench/partition_probe.py``.

    python -m btl_bloomfilter_tpu_torch.probes.partition_probe [--device cpu]

  1. chunk-local sort: every 1024-key chunk sorted by the bitonic kernel
     (``kernels/vmem_sort.py:chunk_bitonic``), the building block of a
     merge or radix scheme;
  2. copy sweep: ``nsteps`` blocks each copying ``k`` chunks of ``rows *
     512`` bytes (``kernels/dma_sweep.py``), the per-(chunk, bucket) write
     pattern of a bucket partition, swept over k and the chunk size; the
     source is seeded random data, so a wrong copy shows. The CUDA kernel
     copies a step's k chunks as one span, so on the card the sweep's time
     depends on its total bytes and not on k;
  3. the flat ``torch.sort`` of all N = 2**22 keys, for reference.

A B-bucket stable partition of N keys makes about N / 1024 * B small
copies, so the time per copy bounds any bucketing pass, and the chunk sort
bounds the local phase.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import dma_sweep as sweep
from ..kernels import vmem_sort
from ..kernels.vmem_sort import CHUNK, chunk_bitonic
from ..ops import u64
from . import blocks_sorted, first_call, parser, time_ms

N = 1 << 22
NSTEPS = 256
SWEEPS = ((16, 8), (64, 2), (64, 8), (256, 2))    # (k, rows)
REPS = 10
SEED = 0


def make_keys(n: int = N, device="cuda") -> torch.Tensor:
    """The probe's keys, (i * 0x9E3779B9) ^ (i >> 16) in uint32, as int32."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return u64.to_u32_bits(((i * 0x9E3779B9) ^ (i >> 16)) & 0xFFFFFFFF)


def dma_sweep(nsteps: int, k: int, rows: int, *, device="cuda",
              seed: int = SEED):
    """``(copy, src)``: src is seeded random int32 [nsteps * k * rows,
    128]; ``copy(src)`` returns the sweep's copy of it."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(
        0, 1 << 32, size=(nsteps * k * rows, sweep.LANES),
        dtype=np.uint32).view(np.int32)).to(device)
    return functools.partial(sweep.sweep_copy, k=k, rows=rows), src


def main(argv=None) -> dict:
    p = parser(__doc__, REPS)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--nsteps", type=int, default=NSTEPS)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    x = make_keys(args.n, dev)
    res = {"sweep_ms": {}}

    flipped = x ^ vmem_sort.SIGN
    first_call(lambda: torch.sort(flipped), dev)
    res["flat_sort_ms"] = time_ms(lambda: torch.sort(flipped), args.reps,
                                  dev)
    print(f"torch flat sort ({args.n} u32): {res['flat_sort_ms']:.4f} ms",
          flush=True)

    for k, rows in SWEEPS:
        copy, src = dma_sweep(args.nsteps, k, rows, device=dev)
        dst, _ = first_call(lambda: copy(src), dev)
        if not torch.equal(dst, src):
            raise AssertionError(f"copy sweep {k}x{rows}: dst != src")
        dt = time_ms(lambda: copy(src), args.reps, dev)
        res["sweep_ms"][(k, rows)] = dt
        print(f"copy sweep: {k} copies x {rows * 512} B per step: "
              f"{dt:.4f} ms", flush=True)
        print(f"  -> {dt / (args.nsteps * k) * 1e6:.2f} ns per copy",
              flush=True)
        del dst, src

    out, secs = first_call(lambda: chunk_bitonic(x), dev)
    res["chunk_bitonic_ms"] = time_ms(lambda: chunk_bitonic(x), args.reps,
                                      dev)
    if not blocks_sorted(out, CHUNK):
        raise AssertionError("chunk sort broken")
    print(f"chunk-local bitonic ({CHUNK}/chunk, {args.n // CHUNK} chunks): "
          f"{res['chunk_bitonic_ms']:.4f} ms (first {secs:.3f}s)",
          flush=True)
    print(f"  -> {res['chunk_bitonic_ms'] / (args.n / CHUNK) * 1e3:.4f} us "
          f"per {CHUNK}-chunk", flush=True)
    return res


if __name__ == "__main__":
    main()
