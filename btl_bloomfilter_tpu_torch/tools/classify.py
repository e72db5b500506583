"""Classify reads against a multi-index Bloom filter on a GPU (or the CPU).

Streams a FASTA of reads, runs the MIBFQuerySupport engine on batches of
reads, and prints per read: header, best ID, best reference header, and
the evidence counts, as the reference's ``tools/classify.py`` does. A
filter built with spaced seeds hashes the reads with its seeds and runs the
engine's spaced-seed mode, where frames with up to ``--max-miss`` missing
positions count.

    python -m btl_bloomfilter_tpu_torch.tools.classify -f reads.fa -b refs.mibf -m 2
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import api
from ..io import fasta, mibf_format
from ..models import mibf, mibf_query
from ..ops import nthash_tables, u64


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-f", dest="fasta", required=True, help="reads FASTA")
    ap.add_argument("-b", dest="mibf", default="filter.mibf")
    ap.add_argument("-m", dest="min_count", type=int, default=2,
                    help="per-ID frame-count promotion threshold")
    ap.add_argument("--max-miss", type=int, default=0)
    ap.add_argument("--extra-frame-limit", type=int, default=10**6)
    ap.add_argument("--best-hit-agree", action="store_true")
    ap.add_argument("--batch", type=int, default=64,
                    help="reads classified per engine call")
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the filter (default cuda)")
    args = ap.parse_args(argv)

    m = mibf_format.load_mibf(args.mibf, device=args.device)
    id_names = {}
    try:
        with open(args.mibf + ".ids") as f:
            for line in f:
                i, name = line.rstrip("\n").split("\t", 1)
                id_names[int(i)] = name
    except FileNotFoundError:
        pass
    num_ids = (max(id_names) if id_names else 0) + 1
    if num_ids <= 1:
        num_ids = int(u64.unsigned(m.data).max()) + 1

    pfp, _sat_prop = mibf.calc_frame_probs(m, num_ids, args.max_miss)
    qs = mibf_query.MIBFQuerySupport(
        m=m, per_frame_prob=pfp, extra_count=2.0,
        extra_frame_limit=args.extra_frame_limit, max_miss=args.max_miss,
        min_count=1, best_hit_agree=args.best_hit_agree)
    mc = np.full(num_ids, args.min_count, np.int32)
    k = m.kmer_size
    hp = api.HashPipeline(k, m.hash_num, tuple(m.sseeds), device=m.device)

    def emit(header, res):
        if not res:
            print(f"{header}\t*\tunclassified")
        else:
            r = res[0]
            name = id_names.get(r.id, str(r.id))
            print(f"{header}\t{r.id}\t{name}\tnsf={r.non_sat_frame_count}"
                  f"\tcount={r.count}\tsolid={r.solid_count}"
                  f"\tprob={r.frame_prob:.3g}")

    def flush(batch):
        if not batch:
            return
        headers, codes_list = zip(*batch)
        fr = hp.frames_batch(codes_list)
        for header, res in zip(headers, qs.query_many(fr.hashes, fr.valid,
                                                      mc)):
            emit(header, res)
        batch.clear()

    # batches of reads of one length bucket, to bound the padding
    batch, batch_bucket = [], None
    for header, seq in fasta.read_fasta(args.fasta):
        codes = nthash_tables.encode_seq(seq)
        if len(codes) < k:
            print(f"{header}\t*\tshort")
            continue
        bucket = api.bucket_length(len(codes), max(64, k))
        if batch_bucket is not None and (bucket != batch_bucket
                                         or len(batch) >= args.batch):
            flush(batch)
            batch_bucket = None
        if batch_bucket is None:
            batch_bucket = bucket
        batch.append((header, codes))
    flush(batch)


if __name__ == "__main__":
    main()
