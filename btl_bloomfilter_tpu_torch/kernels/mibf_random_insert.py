"""The MIBF's random-order, strand-carrying insert (MIBloomFilter::insert):
the CUDA kernel ``csrc/mibf_random_insert.cu`` and its plain version.

``random_insert(bv_words, cum_ranks, rank_dir, data, hashes, size,
id_value, max_count, strand=None, valid=None, schedule=None)`` inserts the
frames hashes int64 [n, h] (uint64 bits) into the ID array ``data`` (uint8
/ int16 / int32 bit patterns for ID widths 1 / 2 / 4) in place, with the
result of a walk in frame order; it returns the frames' success flags,
bool [n]. Frame f's slot i sits at rank rank(hashes[f, i] % size) of the
frozen bit vector and takes the value ``id_value`` (cut to the width), with
the strand bit where ``strand[f, i]`` differs from the insert's direction
(``max_count`` odd); ``valid`` masks frames (an invalid frame writes
nothing and fails). The order, the seeding and the saturation fallback are
the reference's (see the CUDA source); on a frame where the reference
asserts, both forms saturate, as the JAX package's device form does. A
rank past the ID array reads its last entry and writes nothing.

A frame touches only the entries at its keys, ``min(rank, d_size - 1)``
(``slot_keys``), so the kernel runs the frames in rounds: each round runs,
in parallel, every frame that is the lowest frame still to do on each of
its keys; when a round readies fewer than 1/``MIN_SHARE`` of the frames
left, or after ``MAX_ROUNDS`` rounds, one thread walks the rest in order
(the tail). ``round_schedule`` gives each frame its round, or marks it for
the tail, as the kernel decides; ``schedule`` (int32 [3], on the data's
device) receives (rounds that ran frames, frames run in rounds, frames of
the tail), from the kernel's own counters on the card and from
``round_schedule`` on the CPU; a batch past ``CHUNK_SLOTS`` slots runs as
consecutive chunks of frames, one launch each, and the counts sum.

The kernel reads the ranks through the rank directory ``rank_dir``; the
plain version ``random_insert_plain`` through ``bv_words`` and
``cum_ranks`` (``mibf_rank.rank_lookup_plain``), then runs ``frame_step``
on the host, frame after frame in index order (or in the ``order`` given).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import u64
from ..utils import stdcpp
from . import _build, mibf_rank

KERNEL = _build.CudaKernel("btl_mibf_random_insert", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

# slots a frame the kernel takes (RI_MAX_H in the CUDA source)
MAX_H = 4096
# the rounds (RI_MAX_ROUNDS, RI_MIN_SHARE in the CUDA source)
MAX_ROUNDS = 64
MIN_SHARE = 64
# round_schedule's marks
TAIL, INVALID = -1, -2
# slots a launch takes at most; a larger batch launches once a chunk of
# frames, in order
CHUNK_SLOTS = 1 << 24

_NP_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_NP_STORAGE = {1: np.uint8, 2: np.int16, 4: np.int32}   # numpy of the dtypes
_KEY_MAX = 0xFFFFFFFE

_scratch_bytes = None


def _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid) -> None:
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise TypeError("hashes must be a 2-D int64 tensor (uint64 bits)")
    n, h = hashes.shape
    if not 1 <= h <= MAX_H:
        raise ValueError(f"need 1 <= h <= {MAX_H} slots a frame, got {h}")
    if data.dtype not in (torch.uint8, torch.int16, torch.int32) \
            or data.dim() != 1:
        raise TypeError("data must be a 1-D uint8, int16 or int32 tensor")
    if n and not data.numel():
        raise ValueError("the ID array is empty")
    if not 1 <= size <= 32 * bv_words.numel() or size > (1 << 32):
        raise ValueError(f"size {size} outside [1, 32 * words] or past "
                         "2**32 bits")
    if max_count < 1:
        raise ValueError(f"max_count must be >= 1, got {max_count}")
    if strand is not None and (strand.dtype != torch.bool
                               or strand.shape != hashes.shape):
        raise ValueError("strand must be bool shaped like hashes")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise ValueError("valid must be bool [n]")
    mibf_rank._check_dir(rank_dir, bv_words.numel())


def _ranks_plain(bv_words, cum_ranks, rank_dir, hashes, size):
    """int64 [n, h]: each slot's rank in the frozen bit vector."""
    pos = u64.to_u32_bits(u64.mod_const(hashes, size))
    return u64.from_u32_bits(mibf_rank.rank_lookup_plain(
        bv_words, cum_ranks, rank_dir, pos)[0])


def slot_keys(bv_words, cum_ranks, rank_dir, hashes, size, d_size):
    """int64 [n, h]: each slot's key, the ID entry it reads, min(rank,
    d_size - 1) (and at most 2**32 - 2, the kernel's table keys: a
    coarser key only orders more)."""
    return _ranks_plain(bv_words, cum_ranks, rank_dir, hashes, size).clamp(
        max=min(d_size - 1, _KEY_MAX))


def round_schedule(keys: torch.Tensor, valid=None) -> torch.Tensor:
    """int64 [n]: the round (0, 1, ...) in which the kernel runs each frame
    of keys int64 [n, h], ``TAIL`` for the frames its tail walks in order,
    ``INVALID`` for masked frames. A round runs every frame still to do
    that is the lowest such frame on each of its keys; the tail takes the
    rest after a round that readies fewer than 1/MIN_SHARE of the frames
    left, or after MAX_ROUNDS rounds."""
    n = keys.shape[0]
    out = torch.full((n,), INVALID, dtype=torch.int64)
    keys = keys.cpu()
    left = torch.ones(n, dtype=torch.bool) if valid is None \
        else valid.cpu().clone()
    kid = torch.unique(keys, return_inverse=True)[1]
    nkeys = int(kid.max()) + 1 if kid.numel() else 0
    for r in range(MAX_ROUNDS):
        idx = torch.nonzero(left).reshape(-1)
        if not idx.numel():
            break
        k = kid[idx]
        owner = torch.full((nkeys,), n, dtype=torch.int64).scatter_reduce_(
            0, k.reshape(-1), idx[:, None].expand(k.shape).reshape(-1),
            "amin")
        ready = idx[(owner[k] == idx[:, None]).all(-1)]
        out[ready] = r
        left[ready] = False
        nleft = idx.numel() - ready.numel()
        if nleft and (r + 1 == MAX_ROUNDS
                      or ready.numel() * MIN_SHARE < idx.numel()):
            out[left] = TAIL
            break
    return out


def schedule_counts(sched: torch.Tensor):
    """(rounds that ran frames, frames run in rounds, frames of the tail)
    of a ``round_schedule``: the kernel's ``schedule`` report."""
    return (int(sched.max()) + 1 if sched.numel() and sched.max() >= 0
            else 0, int((sched >= 0).sum()), int((sched == TAIL).sum()))


def frame_step(d: list, rk, hv, vals, id_value: int, max_count: int,
               width: int) -> bool:
    """MIBloomFilter::insert of one frame into the entries ``d`` (a list of
    unsigned ints, updated in place): its ranks ``rk``, hashes ``hv``
    (unsigned) and slot values ``vals``; phase A, the seeded shuffle,
    phase B and the saturation fallback, as the kernel's frame routine.
    Returns the frame's success."""
    smask = 1 << (8 * width - 1)
    anti = smask - 1
    last = len(d) - 1
    h = len(rk)
    # phase A
    count, order, saturated, seed = 0, [], True, id_value
    for i in range(h):
        old = d[min(rk[i], last)]
        oldv = old & anti if old > smask else old
        if old <= smask:
            saturated = False
        if oldv == vals[i]:
            count += 1
        else:
            order.append(i)
        if count >= max_count:
            return True
        seed ^= hv[i]
    # phase B
    done = False
    for i in stdcpp.shuffle(order, stdcpp.MinstdRand(seed)):
        if done:
            break
        old = d[min(rk[i], last)]
        if old == 0:
            if rk[i] <= last:
                d[rk[i]] = vals[i]
            count += 1
        if old <= smask:
            saturated = False
        done = count >= max_count
    if count == 0 and not saturated:
        for r in rk:
            if r <= last:
                d[r] |= smask
    return count > 0


def random_insert_plain(bv_words, cum_ranks, rank_dir, data, hashes, size,
                        id_value, max_count, strand=None, valid=None,
                        schedule=None, order=None):
    """``order``: the frames to run, in that order (default every frame in
    index order); a replay of the kernel's rounds passes its schedule's."""
    _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid)
    n, h = hashes.shape
    width = data.element_size()
    sstrand = 1 << (8 * width - 2)
    idv = id_value & ((1 << (8 * width)) - 1)
    ranks = _ranks_plain(bv_words, cum_ranks, rank_dir, hashes, size)
    if schedule is not None:
        # summed over the kernel's launches, one a chunk of frames
        keys = ranks.clamp(max=min(data.numel() - 1, _KEY_MAX))
        chunk = max(1, CHUNK_SLOTS // h)
        schedule.copy_(torch.tensor([sum(c) for c in zip((0, 0, 0), *(
            schedule_counts(round_schedule(
                keys[lo:lo + chunk],
                None if valid is None else valid[lo:lo + chunk]))
            for lo in range(0, n, chunk)))]))
    ranks = ranks.tolist()
    hv = u64.to_numpy(hashes).tolist()
    st = [[False] * h] * n if strand is None else strand.tolist()
    ok = [True] * n if valid is None else valid.tolist()
    d = data.cpu().numpy().view(_NP_UNSIGNED[width]).tolist()
    strand_dir = bool(max_count % 2)
    success = [False] * n
    for f in range(n) if order is None else order:
        if not ok[f]:
            continue
        vals = [idv | sstrand if strand is not None and strand_dir ^ s
                else idv for s in st[f]]
        success[f] = frame_step(d, ranks[f], hv[f], vals, id_value,
                                max_count, width)
    arr = np.array(d, dtype=_NP_UNSIGNED[width])
    data.copy_(torch.from_numpy(arr.view(_NP_STORAGE[width])))
    return torch.tensor(success, dtype=torch.bool, device=data.device)


def _scratch(n: int, h: int, device) -> torch.Tensor:
    """The kernel's working space (owner table, ranks, shuffle orders, the
    tail's list), as ``btl_mibf_random_insert_scratch`` sizes it."""
    global _scratch_bytes
    if _scratch_bytes is None:
        fn = _build.library().btl_mibf_random_insert_scratch
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
        _scratch_bytes = fn
    return torch.empty(_scratch_bytes(n, h), dtype=torch.uint8,
                       device=device)


def random_insert(bv_words, cum_ranks, rank_dir, data, hashes, size,
                  id_value, max_count, strand=None, valid=None,
                  schedule=None):
    _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid)
    tensors = [bv_words, cum_ranks, rank_dir, data, hashes] + [
        t for t in (strand, valid, schedule) if t is not None]
    if _build.on_cpu(*tensors):
        return random_insert_plain(bv_words, cum_ranks, rank_dir, data,
                                   hashes, size, id_value, max_count, strand,
                                   valid, schedule)
    if schedule is not None and (schedule.dtype != torch.int32
                                 or schedule.shape != (3,)):
        raise ValueError("schedule must be int32 [3]")
    dev = data.device
    n, h = hashes.shape
    success = torch.empty(n, dtype=torch.bool, device=dev)
    if schedule is not None:
        schedule.zero_()
    if not n:
        return success
    if not data.is_contiguous():
        raise ValueError("data must be contiguous (it is written in place)")
    hashes = hashes.contiguous()
    strand = None if strand is None else strand.contiguous()
    valid = None if valid is None else valid.contiguous()
    rank_dir = rank_dir.contiguous()
    if rank_dir.data_ptr() % 16:
        raise ValueError("rank_dir must be 16-byte aligned")
    chunk = max(1, CHUNK_SLOTS // h)
    scratch = _scratch(min(n, chunk), h, dev)
    part = None if schedule is None or n <= chunk else \
        torch.empty(3, dtype=torch.int32, device=dev)
    null = ctypes.c_void_p(None)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        stats = schedule if part is None else part
        KERNEL.launch(
            dev, hashes[lo:hi].data_ptr(), hi - lo, h, size,
            rank_dir.data_ptr(), bv_words.numel(), data.data_ptr(),
            data.element_size(), data.numel(), id_value & ((1 << 64) - 1),
            max_count, null if strand is None else _build.ptr(strand[lo:hi]),
            null if valid is None else _build.ptr(valid[lo:hi]),
            scratch.data_ptr(), null if stats is None else _build.ptr(stats),
            success[lo:hi].data_ptr())
        if part is not None:
            schedule += part
    return success
