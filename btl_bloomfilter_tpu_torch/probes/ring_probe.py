"""Steady-state timing of the Bloom insert step through the sorted-scatter
kernels, against the main path; the port of ``bench/ring_probe.py``.

    python -m btl_bloomfilter_tpu_torch.probes.ring_probe [--device cpu]

The production insert step at bench.py's Bloom config (k=31, h=4, 2**30
bits, 512 reads x 2048 bases): the ntHash kernel's positions, an unsigned
``torch.sort``, each duplicate replaced by the sentinel in place, then
either the delta form (``kernels/scatter_ring.py``: a zeros delta and a
separate OR) or the in-place form (``kernels/scatter_or.py:
scatter_or_sorted``). The main path (``kmer_bloom.insert_seq``: positions,
then ``scatter_or`` by the route its rule picks) runs beside them, and the
three filters must be identical. The kernels never overflow on this hardware, so
the step needs no re-apply. On a GPU each form's step is also profiled:
device busy time, idle share and largest kernels under ``torch.profiler``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import nthash_scan, scatter_or, scatter_ring
from ..kernels.vmem_sort import SIGN
from ..models import bloom, kmer_bloom
from ..tools import profile_mibf
from . import first_call, parser, popcount, time_ms

K, H = 31, 4
LOG2_SIZE = 30
B, L = 512, 2048
REPS = 10
SEED = 0


def make_codes(rows: int = B, length: int = L, seed: int = SEED,
               device="cuda") -> torch.Tensor:
    """Random ACGT codes uint8 [rows, length]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 4, size=(rows, length),
                                         dtype=np.uint8)).to(device)


def sorted_positions(codes: torch.Tensor, size: int):
    """The step's positions (int32 holding uint32 bits): ``(pos_d,
    pos_s)``, where pos_s is every slot's position sorted in unsigned order
    (sentinels last) and pos_d is pos_s with each repeat of the position
    before it and each sentinel set to the sentinel."""
    pos, _strand, _valid = nthash_scan.positions_planes(codes, K, H, size)
    pos_s = torch.sort(pos.reshape(-1) ^ SIGN).values ^ SIGN
    keep = torch.ones_like(pos_s, dtype=torch.bool)
    keep[1:] = pos_s[1:] != pos_s[:-1]
    keep &= pos_s != -1
    return torch.where(keep, pos_s, -1), pos_s


def make_step(kernel, size: int):
    """step(words, codes) -> words through a sorted scatter ``kernel``
    (``scatter_ring.scatter_or_sorted`` or ``scatter_or.
    scatter_or_sorted``)."""
    def step(words, codes):
        pos_d, pos_s = sorted_positions(codes, size)
        out, _overflow = kernel(words, pos_d, pos_for_base=pos_s)
        return out
    return step


def main_path_step(size: int):
    """step(words, codes) -> words through ``kmer_bloom.insert_seq``."""
    def step(words, codes):
        bf = bloom.BloomFilter(words=words, size=size, hash_num=H,
                               kmer_size=K)
        return kmer_bloom.insert_seq(bf, codes).words
    return step


def steps(size: int) -> dict:
    return {"delta ring": make_step(scatter_ring.scatter_or_sorted, size),
            "in-place": make_step(scatter_or.scatter_or_sorted, size),
            "main path": main_path_step(size)}


def main(argv=None) -> dict:
    p = parser(__doc__, REPS)
    p.add_argument("--rows", type=int, default=B)
    p.add_argument("--length", type=int, default=L)
    p.add_argument("--log2-size", type=int, default=LOG2_SIZE)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    size = 1 << args.log2_size
    codes = make_codes(args.rows, args.length, device=dev)
    kmers = args.rows * (args.length - K + 1)
    ms, words = {}, {}
    for label, step in steps(size).items():
        holder = [torch.zeros(size // 32, dtype=torch.int32, device=dev)]

        def call():
            holder[0] = step(holder[0], codes)

        _, secs = first_call(call, dev)
        print(f"{label}: first call {secs:.3f}s", flush=True)
        ms[label] = time_ms(call, args.reps, dev)
        print(f"{label}: {ms[label]:.4f} ms/step = "
              f"{kmers / ms[label] / 1e3:.1f}M kmers/s", flush=True)
        words[label] = holder[0]
        if dev.type == "cuda":
            busy, wall, top = profile_mibf.profile(call, args.reps)
            print(f"{label}: device busy {busy:.4f} ms of {wall:.4f} ms per "
                  f"step, idle share {1 - busy / wall:.4f}", flush=True)
            for key, t, n in top:
                print(f"    {t:9.4f} ms  x{n:<3d} {key}", flush=True)
    pops = {label: popcount(w) for label, w in words.items()}
    ref = words["main path"]
    same = all(torch.equal(w, ref) for w in words.values())
    print(f"popcount delta={pops['delta ring']} in-place={pops['in-place']} "
          f"main path={pops['main path']} identical={same}", flush=True)
    if not same:
        raise AssertionError("a sorted-scatter filter differs from the main "
                             "path's")
    return {"ms": ms, "words": words, "codes": codes}


if __name__ == "__main__":
    main()
