"""The exchanges of the distribution layer: bitwise-OR and saturating-add
allreduce, and the gathers, sums and all-to-alls the sharded filters use.

The reference's merge is N workers hammering one shared bit array with
atomic ORs (BloomFilter.hpp:177); ranks that each hold a partial filter
need an OR-allreduce. NCCL has no bitwise-OR reduction, so the OR is built
from pairwise exchanges, each followed by a local ``|=``, and the gloo
tests run the same code NCCL runs (no ``ReduceOp.BOR``). Two schedules, as
in the JAX package:

  * ``or_allreduce_butterfly``: recursive doubling, log2(P) rounds each
    moving the whole array; a world that is not a power of two gathers
    every rank's array and ORs them.
  * ``or_allreduce_rsag``: reduce-scatter by recursive halving (round r
    moves size/2^r), then all-gather by recursive doubling: about twice
    the array a rank, the choice for large filters; a world that is not a
    power of two, or a length not divisible by it, takes the butterfly.

Sums of counts widen to int64 before they are reduced, or to int32 where
the caller bounds them below 2**31: a gloo SUM over uint8 wraps, and
per-increment freezing commutes with the sum because counts are monotone,
so the saturating-add merge is a wide sum and a clamp.

The rule for devices: on gloo, CUDA tensors go through host copies
(``mesh.Mesh.stages_through_host``), decided from the backend and the
tensor's device, never from a failed call. NCCL takes them as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import u64
from .mesh import Mesh


def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective is handed: a host copy on gloo for CUDA
    tensors, the tensor itself otherwise."""
    return t.cpu() if t.is_cuda and mesh.backend == "gloo" else t


def _peer(mesh: Mesh, rank: int) -> int:
    """A rank of the mesh's group as a rank of the default group."""
    if mesh.group is None:
        return rank
    return dist.get_global_rank(mesh.group, rank)


def exchange(x: torch.Tensor, mesh: Mesh, partner: int) -> torch.Tensor:
    """Send ``x`` to ``partner`` and receive its tensor of the same shape
    and dtype: one pairwise exchange."""
    send = _host(mesh, x.contiguous())
    recv = torch.empty_like(send)
    peer = _peer(mesh, partner)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer, mesh.group),
            dist.P2POp(dist.irecv, recv, peer, mesh.group)]):
        req.wait()
    return recv.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank, at least 1-D) stacked
    in rank order along a new axis 0. The bytes travel as uint8, which
    every backend takes (gloo has no int16 or bool)."""
    t = _host(mesh, x.contiguous()).view(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).view(x.dtype).to(x.device)


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the ranks of a contiguous int64 or int32 tensor, in place;
    returns ``x``. An int32 sum is the caller's promise that it stays
    below 2**31."""
    if x.dtype not in (torch.int64, torch.int32) or not x.is_contiguous():
        raise TypeError("sums run on contiguous int64 or int32: narrower "
                        "integers wrap")
    t = _host(mesh, x)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    if t is not x:
        x.copy_(t)
    return x


def all_to_all(x: torch.Tensor, send_counts, recv_counts,
               mesh: Mesh) -> torch.Tensor:
    """Rows of ``x`` (sorted by destination, ``send_counts[j]`` rows for
    rank j) to their ranks; returns the rows received, ``recv_counts[j]``
    from rank j, in rank order. Counts are python ints."""
    t = _host(mesh, x.contiguous())
    out = torch.empty((sum(recv_counts),) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_to_all_single(out, t, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts),
                           group=mesh.group)
    return out.to(x.device)


def exchange_counts(counts: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per-destination counts int64 [P] -> the counts each rank sends
    this one, int64 [P] (one all-to-all of one element a rank)."""
    return all_to_all(counts.to(torch.int64), [1] * mesh.size,
                      [1] * mesh.size, mesh)


def or_allreduce_butterfly(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Bitwise-OR allreduce by recursive doubling: the OR of every rank's
    ``x``, as a new tensor on every rank."""
    p = mesh.size
    if p & (p - 1):
        # not a power of two: gather every rank's array and OR them
        gathered = all_gather(x, mesh)
        out = gathered[0].clone()
        for part in gathered[1:]:
            out |= part
        return out
    out = x.clone()
    step = 1
    while step < p:
        out |= exchange(out, mesh, mesh.rank ^ step)
        step <<= 1
    return out


def or_allreduce_rsag(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Bandwidth-optimal OR-allreduce of a 1-D ``x``: halving
    reduce-scatter, then doubling all-gather. Needs a power-of-two world
    and a length divisible by it; otherwise the butterfly."""
    p, rank = mesh.size, mesh.rank
    n = x.shape[0]
    if p & (p - 1) or n % p:
        return or_allreduce_butterfly(x, mesh)
    buf = x.clone()
    # reduce-scatter: the rank keeps the half its bit of ``step`` names
    step, width, lo = p // 2, n, 0
    while step >= 1:
        half = width // 2
        upper = rank & step
        mine = lo + half if upper else lo
        send = lo if upper else lo + half
        buf[mine:mine + half] |= exchange(buf[send:send + half], mesh,
                                          rank ^ step)
        lo, width, step = mine, half, step // 2
    # all-gather: exchange owned chunks back, doubling them
    step = 1
    while step < p:
        upper = rank & step
        other = lo - width if upper else lo + width
        buf[other:other + width] = exchange(buf[lo:lo + width], mesh,
                                            rank ^ step)
        lo = lo - width if upper else lo
        width, step = 2 * width, step << 1
    return buf


def _narrow(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Unsigned int64 values -> ``dtype`` with the same low bits (int16 and
    int32 hold uint16 / uint32 bit patterns)."""
    if dtype == torch.int32:
        return u64.to_u32_bits(values)
    if dtype == torch.int16:
        return torch.where(values >= (1 << 15), values - (1 << 16),
                           values).to(torch.int16)
    return values.to(dtype)


def saturating_add_allreduce(counts: torch.Tensor, cap: int,
                             mesh: Mesh) -> torch.Tensor:
    """Allreduce of per-rank occurrence counts, clamped at ``cap``, as a
    new tensor of ``counts``' dtype. The counts (uint8, int16 / int32 bit
    patterns of unsigned values, or int64) are widened to int64 before
    the sum, so it cannot wrap."""
    total = all_sum(u64.unsigned(counts).clone(), mesh)
    return _narrow(torch.clamp(total, max=cap), counts.dtype)
