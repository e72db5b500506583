"""Sharded multi-index Bloom filter (MIBF) over the ranks of a
``mesh.Mesh``.

The reference MIBF is single-process shared memory (MIBloomFilter.hpp,
MIBFConstructSupport.hpp); the JAX package's scale-out, one rank a
process, splits the bit vector, the rank structure and the ID array into
P contiguous shards:

  * **bit vector**: rank s owns bits [s*shard_bits, (s+1)*shard_bits).
    Positions are computed in 64 bits and split into (owner, local offset)
    before routing, so a shard's offsets stay uint32 while the whole
    vector may pass 2**32 bits (up to P * 2**32).
  * **rank**: each shard keeps its local exclusive cumulative popcounts;
    the global rank of a position is ``rank_base[owner]`` + its local
    rank. The bases are tiny and replicated.
  * **ID array**: rank-aligned shards: the IDs of the ranks in shard s's
    range live on rank s (padded to the largest shard population,
    ``d_max``), so a lookup never leaves the shard that answered the bit
    test: one all-to-all out and one back.
  * **construction**: phase 1 (insertBV) routes positions as the sharded
    Bloom build does; phase 3 (insertMIBF's reservoir) needs no
    communication: each rank takes the sequence's unique values whose
    positions it owns and runs the single-device ``reservoir_core`` on its
    local rank space (a rank group never spans shards). Phase 4
    (saturation rescue) takes global ranks from the routed lookup,
    fetches a compact table of the touched ID and count entries from
    their owners with one sum, runs the single-device decomposition
    (``saturation_ranks_many``) on it on every rank, and writes each entry
    back to its owner.

Exactness contract: every operation equals the single-device
``models.mibf`` / ``mibf_construct`` pipeline on the joined state, as the
JAX package's does. On a CUDA tensor the per-shard work runs the port's
kernels: scatter-OR for phase 1, the rank kernel for every lookup, and
the frame scan of classification. Ranks are int32, as in the port's
``mibf.freeze``: a filter of 2**31 set bits or more is refused. ID widths
1, 2 and 4, as the JAX package's sharded MIBF takes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..kernels import mibf_rank, scatter_or
from ..models import mibf as mibf_mod
from ..models import mibf_construct as construct
from ..models import mibf_query
from ..ops import u64
from . import collectives
from .dist_bloom import frame_owner_local, route, unique_table
from .mesh import Mesh

_SIGN = -(1 << 63)            # flips uint64 order into int64 order
_NO_RANK = 0xFFFFFFFF         # the stream's sentinel rank: sorts last
_WIDTHS = (1, 2, 4)


@dataclasses.dataclass
class ShardedMIBF:
    """This rank's shard of a sharded MIBF."""

    bv_words: torch.Tensor    # int32 [nwords_per_shard], uint32 bits
    cum_ranks: torch.Tensor   # int32 [nwords_per_shard] (local, exclusive)
    rank_dir: torch.Tensor    # the shard's rank directory (kernels/mibf_rank)
    data: torch.Tensor        # [d_max] IDs, rank-aligned to the bit shard
    counts: torch.Tensor      # [d_max] phase-3 occurrence counters
    rank_base: torch.Tensor   # int64 [p] global rank base a shard (replicated)
    size: int                 # total bit-vector length in bits
    hash_num: int
    kmer_size: int
    d_size: int               # global population (sum of d_sizes)
    d_sizes: tuple            # per-shard population
    data_width: int
    num_shards: int

    @property
    def shard_bits(self) -> int:
        return self.size // self.num_shards

    @property
    def s_mask(self) -> int:
        return 1 << (8 * self.data_width - 1)

    @property
    def s_anti_mask(self) -> int:
        return self.s_mask - 1    # (T)~s_mask, MIBloomFilter.hpp:36-42

    @property
    def device(self) -> torch.device:
        return self.bv_words.device


def _owner_local(hashes: torch.Tensor, m_size: int, p: int, valid=None):
    """Positions of frames hashes int64 [..., h] -> (owner int64 in [0, p],
    p for frames ``valid`` drops; local offset as int32 uint32 bits),
    flat."""
    owner, local = frame_owner_local(hashes, m_size, p, valid)
    return owner, u64.to_u32_bits(local)


# ---------------------------------------------------------------------------
# phase 1: sharded bit-vector build
# ---------------------------------------------------------------------------

def create_bv(mesh: Mesh, expected_entries: int, k: int, hash_num: int,
              occupancy: float = 0.5):
    """Sharded analog of MIBFConstructSupport's ctor
    (MIBFConstructSupport.hpp:36-46): the size from calc_optimalSize,
    rounded up so every shard holds a whole number of words. Returns (this
    rank's zeroed words, size)."""
    p = mesh.size
    size = mibf_mod.calc_optimal_size(expected_entries, hash_num, occupancy)
    size += -size % (p * 32)
    return torch.zeros(size // p // 32, dtype=torch.int32,
                       device=mesh.device), size


def insert_bv(mesh: Mesh, bv_words: torch.Tensor, size: int,
              hashes: torch.Tensor, valid=None, cap=None) -> torch.Tensor:
    """Phase 1 (insertBV, MIBFConstructSupport.hpp:75-87) of this rank's
    block of frames hashes int64 [B/P, W, h]: positions go to their
    shards, which scatter-OR them. Updates ``bv_words`` (this rank's
    shard) in place and returns it."""
    p = mesh.size
    owner, local = _owner_local(hashes.to(bv_words.device), size, p, valid)
    scatter_or.scatter_or(bv_words, route(mesh, local, owner, cap).recv)
    return bv_words


# ---------------------------------------------------------------------------
# phase 2: freeze (rank structure + empty sharded ID array)
# ---------------------------------------------------------------------------

def freeze(mesh: Mesh, bv_words: torch.Tensor, size: int, hash_num: int,
           kmer_size: int, data_width: int = 2) -> ShardedMIBF:
    """Sharded getEmptyMIBF (MIBFConstructSupport.hpp:92-99 /
    MIBloomFilter.hpp:122-147): local exclusive popcount cumsums and the
    global rank bases; one gather of the shard populations sizes the
    rank-aligned ID shards."""
    if data_width not in _WIDTHS:
        raise ValueError(f"the sharded MIBF takes ID widths {_WIDTHS}, got "
                         f"{data_width}")
    pops = u64.popcount32(bv_words)
    cum = torch.cumsum(pops, 0) - pops
    pop_all = collectives.all_gather(pops.sum().reshape(1), mesh).reshape(-1)
    d_sizes = tuple(int(x) for x in pop_all.tolist())
    d_size = sum(d_sizes)
    if d_size >= (1 << 31):
        raise NotImplementedError("MIBF of 2**31 set bits or more is not "
                                  "supported (ranks are int32)")
    cum = cum.to(torch.int32)
    d_max = max(1, max(d_sizes))
    dev = bv_words.device
    base = torch.cumsum(pop_all, 0) - pop_all
    return ShardedMIBF(
        bv_words=bv_words, cum_ranks=cum,
        rank_dir=mibf_rank.rank_directory(bv_words, cum),
        data=torch.zeros(d_max, dtype=mibf_mod.STORAGE[data_width],
                         device=dev),
        counts=torch.zeros(d_max, dtype=mibf_mod.STORAGE[
            construct.count_width(data_width)], device=dev),
        rank_base=base.to(dev), size=size, hash_num=hash_num,
        kmer_size=kmer_size, d_size=d_size, d_sizes=d_sizes,
        data_width=data_width, num_shards=mesh.size)


def _lookup(m: ShardedMIBF, local: torch.Tensor, data=None):
    """(local rank int32, hit bool, raw) of local offsets int32 in this
    rank's shard: one call of the rank kernel."""
    return mibf_rank.rank_lookup(m.bv_words, m.cum_ranks, m.rank_dir, local,
                                 data)


# ---------------------------------------------------------------------------
# phase 3: reservoir ID insertion (no communication)
# ---------------------------------------------------------------------------

def _unique_sorted_u64(hashes: torch.Tensor, valid):
    """Flatten, mask and dedupe hash values int64 (uint64 bits): (the
    unique values in ascending unsigned order, then the all-ones sentinel
    to the end; keep mask, the sentinel dropped). ``reservoir_core`` reads
    only the kept values, in order, so where the rest stand is moot."""
    vals = hashes.reshape(-1)
    if valid is not None:
        v = torch.as_tensor(valid).to(hashes.device)[..., None].broadcast_to(
            hashes.shape).reshape(-1)
        vals = torch.where(v, vals, -1)
    vals = unique_table(vals ^ _SIGN, -1 ^ _SIGN)[1] ^ _SIGN
    # a genuine hash of 2**64-1 collides with the sentinel; as in the
    # single-device pass it is dropped
    return vals, vals != -1


def insert_mibf(mesh: Mesh, m: ShardedMIBF, hashes: torch.Tensor,
                id_value: int, valid=None) -> ShardedMIBF:
    """Phase 3 (insertMIBF, MIBFConstructSupport.hpp:109-130) of one
    sequence's frames hashes int64 [..., h], the same on every rank: each
    rank keeps the sorted unique values whose positions it owns and runs
    ``reservoir_core`` on its local rank space. A rank group lives on one
    shard, so the result equals the single-device pass. Updates ``m.data``
    and ``m.counts`` in place."""
    vals, keep = _unique_sorted_u64(hashes.to(m.device), valid)
    owner, local = _owner_local(vals[:, None], m.size, m.num_shards)
    mine = keep & (owner == mesh.rank)
    lrank, _, _ = _lookup(m, local)
    d_max = m.data.numel()
    ids = torch.full(vals.shape, int(id_value), dtype=torch.int64,
                     device=m.device)
    construct.reservoir_core(m.data, m.counts, lrank, vals, mine, ids,
                             d_max, m.data_width)
    return m


# ---------------------------------------------------------------------------
# phase 4: saturation rescue on a compact table
# ---------------------------------------------------------------------------

def insert_saturation(mesh: Mesh, m: ShardedMIBF, hashes: torch.Tensor,
                      id_value: int, valid=None,
                      max_entangled=None) -> ShardedMIBF:
    """Phase 4 (setSatIfMissing, MIBFConstructSupport.hpp:168-214) of this
    rank's block of frames hashes int64 [B/P, W, h] (every rank the same
    B/P); neither the bit vector nor the ID and count planes leave their
    ranks. A batch reads and writes only the entries at the ranks it
    addresses, so:

      1. each frame's global ranks come from the routed lookup
         (:func:`at_rank_data`);
      2. the ranks' rows are gathered in rank order (stream order);
      3. the table of unique ranks is built on every rank, and each
         entry's ID and count are fetched from its owner with one sum
         (owner s holds ranks [base[s], base[s] + d_sizes[s]));
      4. ``saturation_ranks_many`` (the single-device decomposition) runs
         on the table, the same on every rank;
      5. each updated entry is written back to its owner.

    Equal to the single-device pass on the joined planes. Updates
    ``m.data`` and ``m.counts`` in place."""
    h = hashes.shape[-1]
    dev = m.device
    grank, _hit, _raw = at_rank_data(mesh, m, hashes)
    v_l = (torch.ones(grank.numel() // h, dtype=torch.bool, device=dev)
           if valid is None else torch.as_tensor(valid).to(dev).reshape(-1))
    rk = collectives.all_gather(grank.reshape(-1, h).to(torch.int64),
                                mesh).reshape(-1, h)
    vv = collectives.all_gather(v_l, mesh).reshape(-1)
    n, T = rk.shape[0], rk.numel()
    flat = torch.where(vv[:, None], rk, _NO_RANK).reshape(-1)

    # the unique table and each slot's table index
    uid, trank = unique_table(flat, _NO_RANK)

    # each entry from its owner: ranks past the filter have none
    base = m.rank_base
    owner = torch.searchsorted(base, trank, right=True) - 1
    owner = torch.where(trank >= m.d_size, m.num_shards, owner)
    mine = owner == mesh.rank
    d_max = m.data.numel()
    lidx = torch.where(mine, trank - base[mesh.rank], 0).clamp(max=d_max - 1)
    tdata = collectives.all_sum(torch.where(
        mine, u64.unsigned(m.data[lidx]), 0), mesh)
    tcounts = collectives.all_sum(torch.where(
        mine, u64.unsigned(m.counts[lidx]), 0), mesh)
    tdata = mibf_mod.to_storage(tdata, m.data_width)
    tcounts = mibf_mod.to_storage(tcounts,
                                  construct.count_width(m.data_width))

    # the single-device decomposition on the table
    ids = torch.full((n,), int(id_value), dtype=torch.int64, device=dev)
    construct.saturation_ranks_many(tdata, tcounts, uid.reshape(n, h), vv,
                                    ids, T, m.data_width, max_entangled)

    # this rank's entries back
    dest = lidx[mine]
    m.data[dest] = tdata[mine]
    m.counts[dest] = tcounts[mine]
    return m


def saturate(mesh: Mesh, m: ShardedMIBF, hashes: torch.Tensor
             ) -> ShardedMIBF:
    """Batched MIBloomFilter::saturate (MIBloomFilter.hpp:440-446) of this
    rank's block of frames: OR the saturation bit at every addressed rank.
    Positions go to their owners, which OR locally; no reply. Updates
    ``m.data`` in place."""
    owner, local = _owner_local(hashes.to(m.device), m.size, m.num_shards)
    recv = route(mesh, local, owner).recv
    lrank, _, _ = _lookup(m, recv)
    r = torch.unique(lrank.to(torch.int64))
    r = r[r < m.data.numel()]
    m.data[r] = mibf_mod.to_storage(
        u64.unsigned(m.data[r]) | m.s_mask, m.data_width)
    return m


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def at_rank_data(mesh: Mesh, m: ShardedMIBF, hashes: torch.Tensor,
                 cap=None):
    """Sharded at_rank + getData (MIBloomFilter.hpp:478-515, :646-655) of
    this rank's block of frames hashes int64 [..., h]: (rank int32, hit
    bool, raw int64) shaped like hashes, as ``mibf.at_rank_data``. One
    all-to-all out (local offsets) and one back: the ID of a rank lives
    on the shard that owns the rank's bits. Exact for any ``cap``."""
    owner, local = _owner_local(hashes.to(m.device), m.size, m.num_shards)
    r = route(mesh, local, owner, cap)
    lrank, hit, raw = _lookup(m, r.recv, m.data)
    grank = m.rank_base[mesh.rank] + lrank.to(torch.int64)
    # one int64 reply an entry: raw in the high half, (rank << 1) | hit in
    # the low (ranks are below 2**31)
    packed = (u64.from_u32_bits(raw) << 32) | (grank << 1) | hit.to(
        torch.int64)
    back = r.reply(mesh, packed, hashes.numel()).reshape(hashes.shape)
    rank = ((back & 0xFFFFFFFF) >> 1).to(torch.int32)
    return rank, (back & 1) == 1, u64.shr(back, 32)


# ---------------------------------------------------------------------------
# conversions (tests / IO)
# ---------------------------------------------------------------------------

def to_single(mesh: Mesh, m: ShardedMIBF):
    """The sharded state gathered into a single-device
    ``mibf.MIBloomFilter`` and its counts, on every rank (for
    serialization and the exactness tests)."""
    bv = collectives.all_gather(m.bv_words, mesh).reshape(-1)
    single = mibf_mod.freeze(bv, m.size, m.hash_num, m.kmer_size,
                             data_width=m.data_width)
    data = collectives.all_gather(m.data, mesh)
    counts = collectives.all_gather(m.counts, mesh)
    single.data = torch.cat([data[s, :n] for s, n in enumerate(m.d_sizes)])
    return single, torch.cat([counts[s, :n]
                              for s, n in enumerate(m.d_sizes)])


# ---------------------------------------------------------------------------
# classification against a sharded MIBF (MIBFQuerySupport.hpp:94-130)
# ---------------------------------------------------------------------------

def prep_frames(mesh: Mesh, m: ShardedMIBF, hashes: torch.Tensor, valid,
                max_miss: int):
    """Sharded twin of ``mibf_query.prep_frames``: the bit tests and rank
    + ID lookups of this rank's reads' frames hashes int64 [R/P, W, h] go
    through :func:`at_rank_data`. Returns (raw, hit, usable, misses)."""
    _, hit, raw = at_rank_data(mesh, m, hashes)
    misses = (~hit).sum(dim=-1, dtype=torch.int32)
    usable = torch.as_tensor(valid).to(m.device) & (misses <= max_miss)
    return raw, hit, usable, misses


@dataclasses.dataclass
class ShardedMIBFQuerySupport:
    """Read classification against a ShardedMIBF, the scale-out twin of
    ``mibf_query.MIBFQuerySupport`` (its constructor parameters,
    MIBFQuerySupport.hpp:33-59). Each rank classifies its block of the
    reads: the lookups route through the shards, the per-read engine and
    the host ranking are the single-device ones, so the result lists equal
    those of the joined filter; ``sat_count`` and ``eval_count`` are the
    totals over every rank's reads."""

    mesh: Mesh
    m: ShardedMIBF
    per_frame_prob: Sequence[float]
    extra_count: float
    extra_frame_limit: int
    max_miss: int
    min_count: int
    best_hit_agree: bool
    sat_count: int = 0
    eval_count: int = 0

    def _scan_and_summarize(self, raw, hit, usable, misses, min_count_vec,
                            frame_eval) -> List[List[mibf_query.QueryResult]]:
        out = mibf_query.query_frames_batch(
            self.m, raw, hit, usable, misses, min_count_vec,
            len(self.per_frame_prob), self.extra_frame_limit,
            frame_eval=frame_eval)
        totals = collectives.all_sum(torch.stack([
            out["sat_count"].sum(dtype=torch.int64),
            out["eval_count"].sum(dtype=torch.int64)]), self.mesh)
        self.sat_count, self.eval_count = (int(x) for x in totals.tolist())
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return [mibf_query.summarize(
            out["counts"][r], out["candidates"][r], out["best"][r],
            self.per_frame_prob, self.min_count, self.extra_count,
            self.best_hit_agree) for r in range(out["best"].shape[0])]

    def query_many(self, hashes: torch.Tensor, valid, min_count_vec):
        """Batched query of this rank's reads, hashes int64 [R/P, W, h],
        valid bool [R/P, W]: one ranked result list a read."""
        raw, hit, usable, misses = prep_frames(self.mesh, self.m, hashes,
                                               valid, self.max_miss)
        return self._scan_and_summarize(
            raw, hit, usable, misses, min_count_vec,
            torch.as_tensor(valid).to(self.m.device))

    def query_paired_many(self, hashes1: torch.Tensor, valid1,
                          hashes2: torch.Tensor, valid2, min_count_vec):
        """Batched paired-end query (MIBFQuerySupport.hpp:111-130) of this
        rank's pairs: both ends' lookups route through the shards, then the
        single-device interleave and engine."""
        fr1 = prep_frames(self.mesh, self.m, hashes1, valid1, self.max_miss)
        fr2 = prep_frames(self.mesh, self.m, hashes2, valid2, self.max_miss)
        raw, hit, usable, misses, live = mibf_query.interleave_paired_frames(
            fr1, fr2, valid1, valid2)
        return self._scan_and_summarize(raw, hit, usable, misses,
                                        min_count_vec, live)
