"""Build a Bloom filter from a FASTA file on a GPU (or the CPU).

The same flags and sizing math as the reference's writeBloom tool: -f FASTA,
-k k-mer size, -p target FPR; size = ceil(-n ln p / ln^2 2) rounded up to
a multiple of 64 and hashNum = floor(size / n) * ln 2, with n the input
file's size in bytes.

    python -m btl_bloomfilter_tpu_torch.tools.write_bloom -f reads.fa -k 31 -o out.bf

``--trace FILE`` writes the batch loop's ``torch.profiler`` trace (the
port's ``btl.*`` spans beside the device's work) to FILE and prints the
port's counters.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from .. import native
from ..io import bf_format
from ..models import bloom, kmer_bloom
from ..utils import trace


def filter_specs(n: int, fpr: float):
    """(size in bits, hash count) for n input bytes at target FPR."""
    size = math.ceil((-1 * n * math.log(fpr)) / (math.log(2) * math.log(2)))
    size += 64 - (size % 64)
    return size, int((size // n) * math.log(2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-f", dest="fasta", required=True,
                    help="sequences (multi-FASTA)")
    ap.add_argument("-k", dest="k", type=int, default=15, help="k-mer size")
    ap.add_argument("-p", dest="fpr", type=float, default=0.0001,
                    help="target false positive rate")
    ap.add_argument("-o", dest="out", default="BloomFilter.bf",
                    help="output filter path")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--pad", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the filter (default cuda)")
    ap.add_argument("--trace", metavar="FILE",
                    help="write a Chrome trace of the batch loop to FILE")
    args = ap.parse_args(argv)

    n = os.path.getsize(args.fasta)
    size, hash_num = filter_specs(n, args.fpr)
    print(f"***** Bloom filter specs:\nelements = {n}\nFPR = {args.fpr}\n"
          f"size (bits) = {size}\nhash functions = {hash_num}")

    bf = bloom.create(size, hash_num, args.k, device=args.device)
    t0 = time.time()
    nbatches = 0
    with (trace.profiled(args.trace, bf.device),
          native.FastaReader(args.fasta, args.batch, args.pad,
                             args.k) as reader):
        for codes in reader:
            kmer_bloom.insert_seq(bf, codes)
            nbatches += 1
    if bf.device.type == "cuda":
        torch.cuda.synchronize(bf.device)
    print(f"inserted {nbatches} batches in {time.time() - t0:.3f}s")

    bf_format.store_bloom(bf, args.out)
    print(f"wrote {bf.size_in_bytes} byte filter to {args.out}\nDone!")


if __name__ == "__main__":
    main()
