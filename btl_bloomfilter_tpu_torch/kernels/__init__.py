"""Hand-written CUDA kernels, each beside its plain PyTorch version.

  * ``nthash_scan``  - canonical ntHash positions / hash planes
  * ``scatter_or``   - Bloom insert: direct (atomicOr) or tiled (after the
    tile partition), and of sorted positions (one atomic per run of equal
    words)
  * ``scatter_ring`` - Bloom insert of sorted positions into a new filter,
    in one sweep of the old one
  * ``gather_words`` - Bloom query (gather + AND over h)
  * ``gather_counters`` - counting-filter read (packed lanes, min over h;
    all of a window's loads issued together)
  * ``scatter_add``  - counting-filter saturating add (atomicCAS per lane),
    direct, tiled or, for wide positions past the partition's tiles, sparse
    (one CAS a distinct word): incrementAll
  * ``tile_partition`` - positions grouped by tile of the array they write,
    the first stage of the tiled scatters
  * ``conservative_step`` - counting-filter conservative step (gather, min,
    target and a carry-free atomicAdd per lane in one pass): the insert's
    closed form and replay rounds
  * ``mibf_rank``    - MIBF rank, hit and ID of bit positions (the ID
    plane's uint64 instantiation, width 8, counted as ``mibf_rank_u64``)
  * ``mibf_frame_scan`` - MIBF classification's per-read pass C, as prefix
    scans
  * ``spaced_scan``  - spaced-seed ntHash frames (stHash: m seeds x m2
    hashes, strand flags, valid)
  * ``mibf_random_insert`` - MIBF random-order, strand-carrying insert
    (MIBloomFilter::insert): parallel rounds of frames that share no ID
    entry, then an in-order tail on one thread
  * ``blocked_bloom`` - blocked Bloom filter insert and query (all h
    bits of a k-mer in one 64-byte row), and the insert fused with ntHash
    (``blocked_insert_seq``)
  * ``vmem_sort``    - block-local bitonic sorts (2048- and 1024-key blocks)
  * ``window_scatter`` - static-window Bloom scatter in shared memory
  * ``dma_sweep``    - chunked copy sweep

``scatter_ring`` and the last three serve the probes (``probes/``), not the
build/query paths.
The Bloom kernels (``nthash_scan``'s positions mode, ``scatter_or``'s two
routes, ``tile_partition``, ``gather_words``) also take wide int64
positions, for filters from 2**32 bits, and the counting kernels
(``gather_counters``, ``scatter_add``'s direct and sparse routes,
``conservative_step``) for filters of exactly 2**32 counters, each through
an instantiation counted on its own (the ``*_wide`` names below).
Every wrapper counts the launches of its kernel; ``launch_counts`` and
``reset_launch_counts`` read and clear them.
"""

from . import (blocked_bloom, conservative_step, dma_sweep,
               gather_counters, gather_words, mibf_frame_scan,
               mibf_random_insert, mibf_rank, nthash_scan, scatter_add,
               scatter_or, scatter_ring, spaced_scan, tile_partition,
               vmem_sort, window_scatter)

KERNELS = {
    "nthash_scan": nthash_scan.KERNEL,
    "scatter_or": scatter_or.KERNEL,
    "gather_words": gather_words.KERNEL,
    "gather_counters": gather_counters.KERNEL,
    "scatter_add": scatter_add.KERNEL,
    "mibf_rank": mibf_rank.KERNEL,
    "mibf_frame_scan": mibf_frame_scan.KERNEL,
    "scatter_or_sorted": scatter_or.SORTED_KERNEL,
    "scatter_or_sorted_delta": scatter_ring.KERNEL,
    "sort_blocks": vmem_sort.KERNEL,
    "chunk_bitonic": vmem_sort.CHUNK_KERNEL,
    "window_scatter": window_scatter.KERNEL,
    "dma_sweep": dma_sweep.KERNEL,
    "conservative_step": conservative_step.KERNEL,
    "scatter_or_tiled": scatter_or.TILED_KERNEL,
    "scatter_add_tiled": scatter_add.TILED_KERNEL,
    "tile_partition": tile_partition.KERNEL,
    # the wide forms (int64 positions, Bloom filters from 2**32 bits)
    "nthash_scan_wide": nthash_scan.WIDE_KERNEL,
    "scatter_or_wide": scatter_or.WIDE_KERNEL,
    "scatter_or_tiled_wide": scatter_or.TILED_WIDE_KERNEL,
    "tile_partition_wide": tile_partition.WIDE_KERNEL,
    "gather_words_wide": gather_words.WIDE_KERNEL,
    # the spaced-seed MIBF path
    "spaced_scan": spaced_scan.KERNEL,
    "mibf_random_insert": mibf_random_insert.KERNEL,
    # the width-8 (uint64 ID) MIBF's rank + ID lookup
    "mibf_rank_u64": mibf_rank.U64_KERNEL,
    # the wide forms of the counting kernels (filters of 2**32 counters)
    "gather_counters_wide": gather_counters.WIDE_KERNEL,
    "scatter_add_wide": scatter_add.WIDE_KERNEL,
    "conservative_step_wide": conservative_step.WIDE_KERNEL,
    # incrementAll's sparse route: 2**32 counters, past the partition's tiles
    "scatter_add_sparse_wide": scatter_add.SPARSE_WIDE_KERNEL,
    # the blocked Bloom filter
    "blocked_insert": blocked_bloom.INSERT_KERNEL,
    "blocked_contains": blocked_bloom.CONTAINS_KERNEL,
    "blocked_insert_seq": blocked_bloom.SEQ_KERNEL,
}


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
