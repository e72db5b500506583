"""Build a multi-index Bloom filter from a multi-FASTA on a GPU (or the
CPU): each record gets an ID (1-based record order), for per-reference
read classification. The 4-phase MIBFConstructSupport pipeline with the
flags of the reference's ``tools/build_mibf.py``; writes the ``.mibf`` (with
the spaced seeds, if any, in its header), its ``.sdsl`` sidecar and an
``.ids`` table of record names.

    python -m btl_bloomfilter_tpu_torch.tools.build_mibf -f refs.fa -k 25 -o refs.mibf
    python -m btl_bloomfilter_tpu_torch.tools.build_mibf -f refs.fa -s 11011111,11111011 -o refs.mibf
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import api
from ..io import fasta, mibf_format
from ..models import mibf, mibf_construct
from ..ops import nthash_tables

# padded bases per batch of phases 3 and 4: a batch pads its records to the
# longest one; stream order is kept across batches, so the batching changes
# nothing in the result
BATCH_BASES = 1 << 26


def batches(lengths):
    """Runs (lo, hi) of consecutive records whose batch, padded to its
    longest record, holds at most BATCH_BASES bases; a longer record forms a
    batch of its own."""
    lo, longest = 0, 0
    for i, n in enumerate(lengths):
        if i > lo and max(longest, n) * (i + 1 - lo) > BATCH_BASES:
            yield lo, i
            lo, longest = i, 0
        longest = max(longest, n)
    if lo < len(lengths):
        yield lo, len(lengths)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-f", dest="fasta", required=True,
                    help="reference sequences (multi-FASTA; one ID each)")
    ap.add_argument("-k", dest="k", type=int, default=25)
    ap.add_argument("-g", dest="hash_num", type=int, default=4,
                    help="hash functions per k-mer (in all, with spaced "
                    "seeds: len(seeds) * max(1, g // len(seeds)))")
    ap.add_argument("-b", dest="occupancy", type=float, default=0.5,
                    help="target bit-vector occupancy")
    ap.add_argument("-s", dest="seeds", default="",
                    help="comma-separated spaced seeds (overrides -k)")
    ap.add_argument("-o", dest="out", default="filter.mibf")
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the filter (default cuda)")
    args = ap.parse_args(argv)

    seed_strings = tuple(s for s in args.seeds.split(",") if s)
    if seed_strings:
        args.k = len(seed_strings[0])
    records = list(fasta.read_fasta(args.fasta))
    if not records:
        sys.exit("no FASTA records found")
    total_bases = sum(len(s) for _, s in records)
    print(f"{len(records)} records, {total_bases} bases")

    t0 = time.time()
    st = mibf_construct.create(
        expected_entries=total_bases, k=args.k, hash_num=args.hash_num,
        occupancy=args.occupancy, spaced_seeds=seed_strings,
        device=args.device)
    pipe = api.MIBFConstructPipeline(st)
    encoded = [nthash_tables.encode_seq(seq) for _, seq in records]
    for codes in encoded:
        pipe.insert_bv_seq(codes)
    m = pipe.freeze()
    print(f"bit vector: {pipe.state.filter_size} bits, pop {m.d_size} "
          f"({m.d_size / pipe.state.filter_size:.3f} occupancy)")
    chunks = [(encoded[lo: hi], range(lo + 1, hi + 1))
              for lo, hi in batches([len(c) for c in encoded])]
    for batch, ids in chunks:
        pipe.insert_mibf_batch(batch, ids)
    for batch, ids in chunks:
        pipe.insert_saturation_batch(batch, ids)
    m = pipe.m
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    print(f"built in {time.time() - t0:.2f}s; saturated entries: "
          f"{mibf.get_pop_saturated(m)}")

    mibf_format.store_mibf(m, args.out)
    with open(args.out + ".ids", "w") as f:
        for i, (header, _) in enumerate(records, start=1):
            f.write(f"{i}\t{header}\n")
    print(f"wrote {args.out} (+.sdsl, +.ids)")


if __name__ == "__main__":
    main()
