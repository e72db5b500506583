"""The 2048-key block sort (``kernels/vmem_sort.py:sort_blocks``) against
a full sort and a one-pass stream; the port of ``bench/vmem_sort_probe.py``.

    python -m btl_bloomfilter_tpu_torch.probes.vmem_sort_probe [--device cpu]

The kernel sorts 2048-key blocks locally; a full sort of N keys needs a
further log2(N/2048) merge passes over all of them, each at least one
read and write, so full-sort time >= block time + 11 stream passes at
N = 4 * 2**20. Prints one JSON object: the block sort's, the full
``torch.sort``'s and the stream pass's milliseconds, and whether every
block came out sorted.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels import vmem_sort
from . import blocks_sorted, first_call, parser, time_ms

N = 4 * 1024 * 1024
REPS = 10
SEED = 0


def make_keys(n: int = N, seed: int = SEED, device="cuda") -> torch.Tensor:
    """Random uint32 keys as int32 [n]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
                            .view(np.int32)).to(device)


def main(argv=None) -> dict:
    p = parser(__doc__, REPS)
    p.add_argument("--n", type=int, default=N)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    x = make_keys(args.n, device=dev)
    res = {"n": args.n}
    got, _ = first_call(lambda: vmem_sort.sort_blocks(x), dev)
    res["block_sort_ms"] = time_ms(lambda: vmem_sort.sort_blocks(x),
                                   args.reps, dev)
    res["block_sorted_ok"] = blocks_sorted(got, vmem_sort.BLOCK)
    flipped = x ^ vmem_sort.SIGN        # unsigned order as signed keys
    first_call(lambda: torch.sort(flipped), dev)
    res["full_sort_ms"] = time_ms(lambda: torch.sort(flipped), args.reps,
                                  dev)
    first_call(lambda: x + 1, dev)
    res["stream_pass_ms"] = time_ms(lambda: x + 1, args.reps, dev)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
