"""The static-window Bloom scatter in shared memory, against the atomicOr
insert on the same positions; the port of ``bench/kernel_lab.py``.

    python -m btl_bloomfilter_tpu_torch.probes.kernel_lab [null] [scatter]
        [--slots 4] [--device cpu]

N = 4 * 2**20 sorted random positions into a 2**30-bit filter. Window w
(16384 words) takes the chunks (1024 positions each) idx[s, w], s <
slots: the first chunk whose last word reaches w and the slots - 1 after
it. Variants (``kernels/window_scatter.py``): ``null`` loads and stores
each window (the load/store floor); ``scatter`` ORs the chunks' positions
into the window in shared memory, and stands for both of the JAX probe's
MXU formulations, ``rowmaj`` and ``lanemaj``. A position no chunk of its
window reaches is dropped: the popcount line says whether ``slots``
chunks covered every window. The ``atomicOr`` insert's direct route
(``kernels/scatter_or.py: scatter_or_direct``) is timed on the same
positions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import scatter_or, window_scatter
from ..kernels.window_scatter import CHUNK, WIN_WORDS
from ..ops import u64
from . import first_call, parser, popcount, time_ms

VARIANTS = ("null", "scatter")
LOG2_SIZE = 30
N = 4 * 1024 * 1024
SLOTS = 4
REPS = 10
SEED = 0


def build(variant: str, slots: int, nwords: int, nchunks: int):
    """``run(idx, pos, words2d) -> words2d`` for ``nwords`` filter words
    (a multiple of 16384) as words2d int32 [nwords / 128, 128], idx int32
    [slots, nwords / 16384] and pos int32 [nchunks * 1024]; the words are
    updated in place."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    nwin = nwords // WIN_WORDS

    def run(idx, pos, words2d):
        if (tuple(idx.shape) != (slots, nwin)
                or pos.numel() != nchunks * CHUNK
                or words2d.numel() != nwin * WIN_WORDS):
            raise ValueError("inputs do not match the built shapes")
        return window_scatter.window_scatter(idx, pos, words2d,
                                             scatter=variant == "scatter")
    return run


def chunk_index(pos: torch.Tensor, slots: int, nwords: int) -> torch.Tensor:
    """The probe's chunk -> window map idx int32 [slots, nwin] for sorted
    positions pos (int32 holding uint32 bits, whole chunks)."""
    nchunks = pos.numel() // CHUNK
    last = u64.from_u32_bits(pos[CHUNK - 1::CHUNK]) >> 5
    wstart = torch.arange(nwords // WIN_WORDS, device=pos.device) * WIN_WORDS
    cs = torch.searchsorted(last, wstart)
    return torch.stack([(cs + s).clamp(0, nchunks - 1)
                        for s in range(slots)]).to(torch.int32)


def make_inputs(log2_size: int = LOG2_SIZE, n: int = N, slots: int = SLOTS,
                *, seed: int = SEED, device="cuda"):
    """(idx, pos, words2d): n sorted random positions below 2**log2_size,
    their chunk map, and a zeros filter."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 1 << log2_size, size=n, dtype=np.uint64)
                  .astype(np.uint32))
    pos = torch.from_numpy(pos.view(np.int32)).to(device)
    nwords = (1 << log2_size) // 32
    words = torch.zeros((nwords // 128, 128), dtype=torch.int32,
                        device=device)
    return chunk_index(pos, slots, nwords), pos, words


def main(argv=None) -> dict:
    p = parser(__doc__, REPS)
    p.add_argument("variants", nargs="*", metavar="variant",
                   help=f"any of {', '.join(VARIANTS)} (default all)")
    p.add_argument("--slots", type=int, default=SLOTS)
    p.add_argument("--log2-size", type=int, default=LOG2_SIZE)
    p.add_argument("--n", type=int, default=N)
    args = p.parse_args(argv)
    variants = args.variants or VARIANTS
    if not set(variants) <= set(VARIANTS):
        p.error(f"variants must be among {VARIANTS}")
    dev = torch.device(args.device)
    idx, pos, words = make_inputs(args.log2_size, args.n, args.slots,
                                  device=dev)
    nwords, nchunks = words.numel(), args.n // CHUNK
    expect = scatter_or.scatter_or_direct(
        torch.zeros(nwords, dtype=torch.int32, device=dev), pos)
    expc = popcount(expect)
    res = {"ms": {}}
    for variant in variants:
        run = build(variant, args.slots, nwords, nchunks)
        w = words.clone()
        out, _ = first_call(lambda: run(idx, pos, w), dev)
        if variant == "scatter":
            popc = popcount(out)
            res["complete"] = torch.equal(out.reshape(-1), expect)
            print(f"popcount {popc} vs expected {expc} "
                  f"{'OK' if popc == expc else 'MISMATCH'}", flush=True)
        res["ms"][variant] = time_ms(lambda: run(idx, pos, w), args.reps,
                                     dev)
        print(f"{variant} slots={args.slots}: {res['ms'][variant]:.4f} ms",
              flush=True)
    wk = torch.zeros(nwords, dtype=torch.int32, device=dev)
    first_call(lambda: scatter_or.scatter_or_direct(wk, pos), dev)
    res["ms"]["scatter_or"] = time_ms(
        lambda: scatter_or.scatter_or_direct(wk, pos), args.reps, dev)
    print(f"scatter_or (atomicOr) on the same positions: "
          f"{res['ms']['scatter_or']:.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
