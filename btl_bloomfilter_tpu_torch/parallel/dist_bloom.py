"""Distributed Bloom filters over the ranks of a ``mesh.Mesh``.

The reference is single-process shared memory; the JAX package's two
strategies, one rank a process:

  * **Replicated / data-parallel** (``dp_insert_seq``): every rank holds
    the whole bit array, hashes its block of the read batch, inserts it
    into a zeroed delta, and the deltas merge by an OR-allreduce. Bit-OR
    commutes, so the filter equals a serial build.

  * **Sharded** (``ShardedBloomFilter``): the bit array is split into P
    contiguous shards, rank r holding bits [r*size/P, (r+1)*size/P). Each
    rank hashes its frames, splits every position into (owner, local
    offset), and sends the offsets to their owners, which scatter-OR them
    into their shards. Queries send the offsets the same way and the
    owners' hit bits come back.

Routing is exact in one round: one all-to-all of the P per-owner counts,
then one all-to-all with those uneven split sizes. The JAX package's send
cap, its [P, cap] buffer and its repair rounds exist because XLA needs
static shapes; ``cap`` stays in the signatures, and the insert reports
the same ``rerouted`` statistic, the positions past each owner's cap that
the JAX package sends in extra rounds.

The per-shard work is the port's Bloom model: on a CUDA tensor the
ntHash, scatter-OR and gather kernels. A shard stays below 2**32 bits so
its local offsets are uint32 (int32 bit patterns).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import bloom, kmer_bloom
from ..ops import u64
from . import collectives
from .mesh import Mesh

# ---------------------------------------------------------------------------
# replicated (data-parallel) build
# ---------------------------------------------------------------------------


def dp_insert_seq(mesh: Mesh, bf: bloom.BloomFilter,
                  codes) -> bloom.BloomFilter:
    """Data-parallel sequence insertion: ``codes`` [B/P, L] is this rank's
    block of the batch; the filter is replicated and the ranks' deltas
    merge by an OR-allreduce. Updates ``bf.words`` in place."""
    delta = bloom.create(bf.size, bf.hash_num, bf.kmer_size,
                         device=bf.device)
    kmer_bloom.insert_seq(delta, codes)
    bf.words |= collectives.or_allreduce_rsag(delta.words, mesh)
    return bf


def dp_contains_seq(mesh: Mesh, bf: bloom.BloomFilter, codes):
    """Data-parallel query of this rank's block [B/P, L] against the
    replicated filter: (hit, valid) bool [B/P, W]."""
    return kmer_bloom.contains_seq(bf, codes)


# ---------------------------------------------------------------------------
# sharded filter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedBloomFilter:
    """Bit array split into ``num_shards`` contiguous shards; ``words``
    (int32, uint32 bits) is this rank's shard, row ``rank`` of the JAX
    package's [num_shards, words_per_shard]."""

    words: torch.Tensor
    size: int
    hash_num: int
    kmer_size: int
    num_shards: int

    @property
    def shard_bits(self) -> int:
        return self.size // self.num_shards

    @property
    def device(self) -> torch.device:
        return self.words.device

    def shard(self) -> bloom.BloomFilter:
        """This rank's shard as a Bloom filter of ``shard_bits`` bits,
        sharing the words."""
        return bloom.BloomFilter(words=self.words, size=self.shard_bits,
                                 hash_num=self.hash_num,
                                 kmer_size=self.kmer_size)


def _check_shard_bits(shard_bits: int) -> None:
    if shard_bits >= (1 << 32):
        raise NotImplementedError("sharded routing requires per-shard "
                                  "size < 2**32 bits (add shards)")


def create_sharded(mesh: Mesh, size: int, hash_num: int,
                   kmer_size: int) -> ShardedBloomFilter:
    p = mesh.size
    if size % (p * 32) != 0:
        raise ValueError(f"size must be a multiple of 32*num_shards ({p*32})")
    if size // p >= (1 << 32):
        raise ValueError("per-shard size must stay below 2**32 bits so "
                         "local offsets fit one uint32 limb; add shards")
    words = torch.zeros(size // p // 32, dtype=torch.int32,
                        device=mesh.device)
    return ShardedBloomFilter(words=words, size=size, hash_num=hash_num,
                              kmer_size=kmer_size, num_shards=p)


def _default_cap(n: int, p: int) -> int:
    """The JAX package's send-buffer slots per destination shard: about
    twice the expected per-shard load of a uniform hash stream (rounded up
    to 8), clamped to n. Here it only sizes the ``rerouted`` statistic."""
    c = 2 * ((n + p - 1) // p)
    c = min(n, ((c + 7) // 8) * 8)
    return max(c, 1)


def route_prepare(payload: torch.Tensor, owner: torch.Tensor, p: int):
    """Owner-sort a payload for routing. ``owner`` is each entry's
    destination rank in [0, p), or p for entries to drop (they sort last
    and are never sent). Returns (payload_s, owner_s, slot, order,
    counts): the payload in stable owner order, each entry's slot among
    its owner's entries, the sort permutation, and per-owner counts int64
    [p]."""
    n = payload.shape[0]
    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    counts = torch.bincount(owner_s, minlength=p + 1)[:p]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=payload.device) - starts[
        owner_s.clamp(max=p - 1)]
    return payload[order], owner_s, slot, order, counts


def owner_local(pos: torch.Tensor, shard: int, p: int, valid=None):
    """Global positions int64 (values below p * shard) -> (owner int64 in
    [0, p], p for entries ``valid`` drops; local offset int64 < shard)."""
    owner = torch.div(pos, shard, rounding_mode="floor")
    local = pos - owner * shard
    if valid is not None:
        owner = torch.where(valid, owner, p)
    return owner, local


def frame_owner_local(hashes: torch.Tensor, size: int, p: int, valid=None):
    """Every position (hash % size) of frames hashes int64 [..., h], flat,
    as :func:`owner_local` over shards of size / p; frames with ``valid``
    (bool [...]) False are dropped."""
    pos = u64.mod_const(hashes.reshape(-1), size)
    if valid is not None:
        valid = torch.as_tensor(valid).to(hashes.device)[..., None]
        valid = valid.broadcast_to(hashes.shape).reshape(-1)
    return owner_local(pos, size // p, p, valid)


@dataclasses.dataclass
class Route:
    """One exact routing of entries to their owners: ``recv`` the payload
    this rank received (rows from rank 0 first); ``order``, ``counts`` and
    ``recv_counts`` (python ints) to send replies back."""

    recv: torch.Tensor
    order: torch.Tensor
    counts: list
    recv_counts: list
    rerouted: int      # this rank's entries past the cap

    def reply(self, mesh: Mesh, values: torch.Tensor,
              n: int) -> torch.Tensor:
        """Send ``values`` (one a received entry) back to the ranks that
        asked; returns the answers in this rank's entry order, [n, ...],
        with zeros where an entry was dropped."""
        back = collectives.all_to_all(values, self.recv_counts, self.counts,
                                      mesh)
        out = torch.zeros((n,) + tuple(back.shape[1:]), dtype=back.dtype,
                          device=back.device)
        out[self.order[:back.shape[0]]] = back
        return out


def route(mesh: Mesh, payload: torch.Tensor, owner: torch.Tensor,
          cap=None) -> Route:
    """Send each entry of ``payload`` to rank ``owner`` (p drops it)."""
    p, n = mesh.size, payload.shape[0]
    payload_s, _, _, order, counts = route_prepare(payload, owner, p)
    c = _default_cap(n, p) if cap is None else min(cap, n)
    recv_counts = collectives.exchange_counts(counts, mesh).tolist()
    counts = counts.tolist()
    recv = collectives.all_to_all(payload_s[:sum(counts)], counts,
                                  recv_counts, mesh)
    return Route(recv=recv, order=order, counts=counts,
                 recv_counts=recv_counts,
                 rerouted=sum(max(k - c, 0) for k in counts))


def unique_table(flat: torch.Tensor, sentinel: int):
    """The table of a stream's unique keys: flat int64 [T] -> (uid int64
    [T], each entry's table index; table int64 [T], the unique keys in
    ascending order, then ``sentinel`` to the end). The sort is stable, so
    equal keys keep stream order."""
    T = flat.numel()
    flat_s, pidx_s = torch.sort(flat, stable=True)
    keep = torch.ones(T, dtype=torch.bool, device=flat.device)
    keep[1:] = flat_s[1:] != flat_s[:-1]
    uid_s = torch.cumsum(keep, 0) - 1
    uid = torch.empty_like(uid_s)
    uid[pidx_s] = uid_s
    table = torch.full((T,), sentinel, dtype=torch.int64, device=flat.device)
    table[uid_s[keep]] = flat_s[keep]
    return uid, table


def _route_frames(mesh: Mesh, sbf: ShardedBloomFilter, hashes: torch.Tensor,
                  valid, cap) -> Route:
    """Local offsets of every position of frames hashes int64 [..., h],
    routed to their shards (frames with ``valid`` False dropped)."""
    _check_shard_bits(sbf.shard_bits)
    owner, local = frame_owner_local(hashes.to(sbf.device), sbf.size,
                                     sbf.num_shards, valid)
    return route(mesh, u64.to_u32_bits(local), owner, cap)


def sharded_insert_frames(mesh: Mesh, sbf: ShardedBloomFilter,
                          hashes: torch.Tensor, valid=None, cap=None):
    """Insert frames: hashes int64 [B/P, W, h], this rank's block.
    Updates the shard in place; returns (sbf, rerouted), ``rerouted`` the
    sum over ranks and owners of max(count - cap, 0): the positions the
    JAX package delivers in repair rounds (0 at its default cap for a
    uniform stream). The result is exact for any ``cap``."""
    r = _route_frames(mesh, sbf, hashes, valid, cap)
    bloom.insert_sentinel_positions(sbf.shard(), r.recv)
    rerouted = collectives.all_sum(
        torch.tensor([r.rerouted], dtype=torch.int64, device=sbf.device),
        mesh)
    return sbf, int(rerouted[0])


def sharded_contains_frames(mesh: Mesh, sbf: ShardedBloomFilter,
                            hashes: torch.Tensor, cap=None) -> torch.Tensor:
    """Query frames hashes int64 [B/P, W, h] against the sharded filter;
    returns bool [B/P, W] (all h bits set). Exact for any ``cap``: no
    position is dropped, so there are no false negatives
    (BloomFilter.hpp:237-262)."""
    r = _route_frames(mesh, sbf, hashes, None, cap)
    hit = bloom.contains_sentinel_positions(sbf.shard(), r.recv[None])
    back = r.reply(mesh, hit.to(torch.uint8), hashes.numel())
    return (back.reshape(hashes.shape) == 1).all(dim=-1)
