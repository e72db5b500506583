"""Distributed counting Bloom filters over the ranks of a ``mesh.Mesh``.

Three scale-outs of CountingBloomFilter.hpp, the JAX package's designs
one rank a process (the reference is single-process shared memory):

* **Data-parallel incrementAll** (``dp_insert_all_seq``): incrementAll
  (CountingBloomFilter.hpp:165-183) is a saturating per-counter increment,
  so it distributes exactly: each rank counts its block's occurrences into
  an int32 histogram, the histograms sum across ranks, and one saturating
  weighted add applies the total, equal to any insertion order.

* **Sharded counter plane** (``ShardedCountingBloomFilter``): rank r owns
  counters [r*size/P, (r+1)*size/P). incrementAll routes each position's
  local offset to its owner (``dist_bloom.route``, exact in one round);
  queries route offsets out and counter values back.

* **Exact distributed conservative update** (``sharded_insert``):
  incrementMin (CountingBloomFilter.hpp:135-162) depends on order, but a
  batch reads and writes only the counters it touches. The ranks gather
  the stream in rank order (stream order), build the table of its unique
  positions, fetch their values from the owners with one sum, run the
  single-device decomposition (``counting.insert_positions``) on the
  table, replicated, and write each entry back to its owner: bit-identical
  to the sequential stream on the joined counters.

A shard keeps the single-device layout: widths 1, 2 and 4 as packed int32
words, width 8 as one int64 plane (uint64 bits; the JAX package keeps two
uint32 planes), so the per-shard work runs the port's counting kernels on
a CUDA tensor: ``gather_counters`` for reads, ``scatter_add`` for
increments, ``conservative_step`` for the table. A shard stays below
2**32 counters so its offsets are uint32.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import scatter_add
from ..models import counting
from ..ops import u64
from . import collectives
from .dist_bloom import (frame_owner_local, owner_local, route,
                         unique_table)
from .mesh import Mesh

# the stream's sentinel position: above every counter index, so it sorts
# last as the JAX package's all-ones limb pair does
_NO_POS = torch.iinfo(torch.int64).max
# log2(counters per packed word) by counter width
_SHIFT = {1: 2, 2: 1, 4: 0}


def dp_insert_all_seq(mesh: Mesh, cbf: counting.CountingBloomFilter,
                      codes) -> counting.CountingBloomFilter:
    """Data-parallel incrementAll of this rank's block [B/P, L] of a
    code batch into the replicated filter; exact. Updates
    ``cbf.counters`` in place."""
    pos, _valid, _shape = counting._positions_seq(cbf, codes)
    p = u64.positions64(pos.reshape(-1))
    p = p[p >= 0]
    # a counter's total is at most the batch's positions, P times this
    # block's: below 2**31 (every real batch) the histogram and its sum
    # are int32, the same choice on every rank
    wide = pos.numel() * mesh.size >= (1 << 31)
    occ = torch.zeros(cbf.size, dtype=torch.int64 if wide else torch.int32,
                      device=p.device)
    occ.index_add_(0, p, torch.ones(p.numel(), dtype=occ.dtype,
                                    device=p.device))
    total = collectives.all_sum(occ, mesh)
    idx = torch.nonzero(total).reshape(-1)
    add = total[idx].to(torch.int64)
    if cbf.is_u64:
        cbf.counters[idx] = u64.add_sat(cbf.counters[idx], add)
        return cbf
    # one weighted saturating add; a total past the counter's maximum
    # saturates the same as its clamp does
    scatter_add.scatter_add(cbf.counters, u64.to_u32_bits(idx),
                            _SHIFT[cbf.counter_width], cbf.counter_max,
                            u64.to_u32_bits(add.clamp(max=cbf.counter_max)))
    return cbf


def dp_contains_seq(mesh: Mesh, cbf: counting.CountingBloomFilter, codes):
    """Data-parallel membership of this rank's block [B/P, L] against the
    replicated counters: (hit, valid) bool [B/P, W]."""
    return counting.contains_seq(cbf, codes)


# ---------------------------------------------------------------------------
# sharded counter plane
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedCountingBloomFilter:
    """Counter array split into ``num_shards`` contiguous range shards:
    shard s owns counters [s*size/p, (s+1)*size/p). ``counters`` is this
    rank's shard in the single-device layout (widths 1/2/4: packed int32
    words, width 8: an int64 plane)."""

    counters: torch.Tensor
    size: int                  # total number of counters
    hash_num: int
    kmer_size: int
    count_threshold: int
    counter_width: int
    num_shards: int

    @property
    def shard_size(self) -> int:
        return self.size // self.num_shards

    @property
    def is_u64(self) -> bool:
        return self.counter_width == 8

    @property
    def counter_max(self) -> int:
        return (1 << (8 * self.counter_width)) - 1

    @property
    def device(self) -> torch.device:
        return self.counters.device

    def shard(self) -> counting.CountingBloomFilter:
        """This rank's shard as a counting filter of ``shard_size``
        counters, sharing the counters tensor."""
        return counting.CountingBloomFilter(
            counters=self.counters, size=self.shard_size,
            hash_num=self.hash_num, kmer_size=self.kmer_size,
            count_threshold=self.count_threshold,
            counter_width=self.counter_width)


def create_sharded(mesh: Mesh, size_in_bytes: int, hash_num: int,
                   kmer_size: int, count_threshold: int,
                   counter_width: int = 1) -> ShardedCountingBloomFilter:
    """Sharded analog of counting.create: sizeInBytes rounds up to a
    multiple of 8 (CountingBloomFilter.hpp:31-50) and of the shard count
    so every shard holds the same number of counters."""
    p = mesh.size
    size_in_bytes += -size_in_bytes % (8 * p)
    size = size_in_bytes // counter_width
    if size // p >= (1 << 32):
        raise ValueError("per-shard size must stay below 2**32 counters "
                         "so local offsets fit one uint32 limb; add "
                         "shards")
    shard = counting.create(size_in_bytes // p, hash_num, kmer_size,
                            count_threshold, counter_width,
                            device=mesh.device)
    return ShardedCountingBloomFilter(
        counters=shard.counters, size=size, hash_num=hash_num,
        kmer_size=kmer_size, count_threshold=count_threshold,
        counter_width=counter_width, num_shards=p)


def _route_positions(mesh: Mesh, scbf: ShardedCountingBloomFilter,
                     hashes: torch.Tensor, valid, cap):
    """Every counter index of frames hashes int64 [..., h] as its local
    offset, routed to its owner (frames with ``valid`` False dropped)."""
    owner, local = frame_owner_local(hashes.to(scbf.device), scbf.size,
                                     scbf.num_shards, valid)
    return route(mesh, local, owner, cap)


def sharded_insert_all(mesh: Mesh, scbf: ShardedCountingBloomFilter,
                       hashes: torch.Tensor, valid=None, cap=None
                       ) -> ShardedCountingBloomFilter:
    """Sharded incrementAll (CountingBloomFilter.hpp:165-183) of frames
    hashes int64 [B/P, W, h], this rank's block: each counter index goes
    to its owner, which adds all it receives with saturation. Exact for
    any ``cap``. Updates the shard in place."""
    r = _route_positions(mesh, scbf, hashes, valid, cap)
    if scbf.is_u64:
        uniq, occ = torch.unique(r.recv, return_counts=True)
        scbf.counters[uniq] = u64.add_sat(scbf.counters[uniq], occ)
    else:
        scatter_add.scatter_add(scbf.counters, u64.to_u32_bits(r.recv),
                                _SHIFT[scbf.counter_width], scbf.counter_max)
    return scbf


def _read(scbf: ShardedCountingBloomFilter,
          local: torch.Tensor) -> torch.Tensor:
    """Counter values (int64, uint64 bits at width 8) of this rank's shard
    at local offsets int64 [n], 0 where the offset is the sentinel -1: a
    one-plane ``counting.min_count_sentinel_positions`` (the
    gather_counters kernel at widths 1/2/4)."""
    return counting.min_count_sentinel_positions(
        scbf.shard(), u64.to_u32_bits(local)[None])


def sharded_min_count(mesh: Mesh, scbf: ShardedCountingBloomFilter,
                      hashes: torch.Tensor, cap=None) -> torch.Tensor:
    """Sharded minimum-counter query (CountingBloomFilter.hpp:54-64) of
    frames hashes int64 [B/P, W, h]: positions go to their owners and
    counter values come back. Returns int64 [B/P, W] (uint64 bits at
    width 8), as ``counting.min_count``."""
    r = _route_positions(mesh, scbf, hashes, None, cap)
    vals = r.reply(mesh, _read(scbf, r.recv), hashes.numel()).reshape(
        hashes.shape)
    if scbf.is_u64:
        return u64.amin(vals, dim=-1)
    return vals.amin(dim=-1)


def sharded_contains(mesh: Mesh, scbf: ShardedCountingBloomFilter,
                     hashes: torch.Tensor, cap=None) -> torch.Tensor:
    """Sharded membership (CountingBloomFilter.hpp:190-196): min count >=
    count_threshold, bool [B/P, W]."""
    mc = sharded_min_count(mesh, scbf, hashes, cap)
    if scbf.is_u64:
        return u64.ge(mc, torch.tensor(u64.as_signed(scbf.count_threshold),
                                       device=mc.device))
    return mc >= scbf.count_threshold


def sharded_insert(mesh: Mesh, scbf: ShardedCountingBloomFilter,
                   hashes: torch.Tensor, valid=None, max_entangled=None
                   ) -> ShardedCountingBloomFilter:
    """Exact distributed conservative update (incrementMin,
    CountingBloomFilter.hpp:135-162) of frames hashes int64 [B/P, W, h],
    this rank's block (every rank the same B/P):

      1. gather the ranks' positions in rank order, which is stream order;
      2. build the table of unique positions and each slot's table index;
      3. fetch the table's values from the owners with one sum (each
         entry has one owner, the others add 0);
      4. run the single-device decomposition ``counting.insert_positions``
         (``insert_positions_u64`` at width 8) on the table, the same on
         every rank;
      5. write each updated entry back to its owner's shard.

    Bit-identical to ``counting.insert`` on the joined counters. Updates
    the shard in place."""
    h = hashes.shape[-1]
    dev = scbf.device
    pos_l = u64.mod_const(hashes.to(dev).reshape(-1, h), scbf.size)
    v_l = (torch.ones(pos_l.shape[0], dtype=torch.bool, device=dev)
           if valid is None else torch.as_tensor(valid).to(dev).reshape(-1))
    # 1. the stream, replicated
    pos = collectives.all_gather(pos_l, mesh).reshape(-1, h)
    vv = collectives.all_gather(v_l, mesh).reshape(-1)
    n, T = pos.shape[0], pos.numel()
    flat = torch.where(vv[:, None], pos, _NO_POS).reshape(-1)

    # 2. unique table + per-slot table ids
    uid, tpos = unique_table(flat, _NO_POS)

    # 3. the table's values from their owners
    owner, local = owner_local(tpos, scbf.shard_size, scbf.num_shards)
    mine = owner == mesh.rank           # the sentinel's owner is past p
    cur = _read(scbf, torch.where(mine, local, -1))
    table = collectives.all_sum(cur, mesh)

    # 4. the decomposition on the compact table, one counter a word (the
    # width's counter_max keeps the increments and the freeze exact)
    if scbf.is_u64:
        counting.insert_positions_u64(table, uid.reshape(n, h), vv, T,
                                      max_entangled)
        # 5. write back this rank's entries
        scbf.counters[local[mine]] = table[mine]
        return scbf
    words = u64.to_u32_bits(table)
    counting.insert_positions(words, uid.reshape(n, h), vv,
                              scbf.counter_max, T, 1, max_entangled)
    # 5. write back this rank's entries: a conservative update only raises
    # counters, and new <= counter_max, so the growth adds without
    # saturating (one weighted add; entries are distinct)
    grow = u64.from_u32_bits(words) - table
    scatter_add.scatter_add(scbf.counters, u64.to_u32_bits(local[mine]),
                            _SHIFT[scbf.counter_width], scbf.counter_max,
                            u64.to_u32_bits(grow[mine]))
    return scbf
