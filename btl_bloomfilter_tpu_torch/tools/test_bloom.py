"""Query a Bloom filter with every k-mer of a FASTA file on a GPU (or the
CPU), as the reference's testBloom tool does; prints "Found N out of M" on
stderr.

    python -m btl_bloomfilter_tpu_torch.tools.test_bloom -f reads.fa -b out.bf

``--trace FILE`` writes the batch loop's ``torch.profiler`` trace (the
port's ``btl.*`` spans beside the device's work) to FILE and prints the
port's counters.
"""

from __future__ import annotations

import argparse
import sys

from .. import native
from ..io import bf_format
from ..models import kmer_bloom
from ..utils import trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-f", dest="fasta", required=True)
    ap.add_argument("-b", dest="bf", default="BloomFilter.bf",
                    help="filter path")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--pad", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the filter (default cuda)")
    ap.add_argument("--trace", metavar="FILE",
                    help="write a Chrome trace of the batch loop to FILE")
    args = ap.parse_args(argv)

    bf = bf_format.load_bloom(args.bf, device=args.device)
    total = hits = 0
    with (trace.profiled(args.trace, bf.device),
          native.FastaReader(args.fasta, args.batch, args.pad,
                             bf.kmer_size) as reader):
        for codes in reader:
            found, valid = kmer_bloom.contains_seq(bf, codes)
            total += int(valid.sum())
            hits += int(found.sum())
    print(f"Found {hits} out of {total}", file=sys.stderr)


if __name__ == "__main__":
    main()
