"""A configuration and mixes small enough for the CPU, with the shapes of
the real ones (several sequences, N runs, overlapping rows, a pool)."""

from portbench.reference.bloom import writebloom_specs

SIZE, H = writebloom_specs(60_000, 1e-4)
CONFIG = {"name": "tiny", "filter": "bloom", "fpr": 1e-4,
          "fasta_bytes": 60_000, "size_bits": SIZE, "hash_num": H,
          "kmer_size": 31,
          "sequences": {"a": 30_000, "b": 20_000, "c": 500, "d": 20},
          "n_runs": 3, "n_run_min": 100, "n_run_max": 1000}
BUILD = {"kind": "build", "batch": 16, "pad": 256}
QUERY = {"kind": "query", "fill": "build", "batch": 64, "read_length": 50,
         "pad": 50, "host_share": 0.9, "substitution_rate": 0.01,
         "reverse_share": 0.5, "pool_batches": 3}
MIXES = {"build": BUILD, "query": QUERY}
