"""Hand-written CUDA kernels of the build/query path, each beside its plain
PyTorch version.

  * ``nthash_scan``  - canonical ntHash positions / hash planes
  * ``scatter_or``   - Bloom insert (atomicOr)
  * ``gather_words`` - Bloom query (gather + AND over h)
  * ``gather_counters`` - counting-filter read (packed lanes, min over h)
  * ``scatter_add``  - counting-filter saturating add (atomicCAS per lane)
  * ``mibf_rank``    - MIBF rank, hit and ID of bit positions
  * ``mibf_frame_scan`` - MIBF classification's sequential per-read pass

Every wrapper counts the launches of its kernel; ``launch_counts`` and
``reset_launch_counts`` read and clear them.
"""

from . import (gather_counters, gather_words, mibf_frame_scan, mibf_rank,
               nthash_scan, scatter_add, scatter_or)

KERNELS = {
    "nthash_scan": nthash_scan.KERNEL,
    "scatter_or": scatter_or.KERNEL,
    "gather_words": gather_words.KERNEL,
    "gather_counters": gather_counters.KERNEL,
    "scatter_add": scatter_add.KERNEL,
    "mibf_rank": mibf_rank.KERNEL,
    "mibf_frame_scan": mibf_frame_scan.KERNEL,
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
