"""Saturating add into packed counters: the CUDA kernel
``csrc/scatter_add.cu`` and its plain PyTorch version.

``scatter_add(words, pos, shift, counter_max, inc=None)`` sets counter p
(lane ``p & (per - 1)`` of ``words[p >> shift]``, ``per = 1 << shift``) to
``min(counter + inc, counter_max)`` for every pair of position p and
increment inc (int32 holding uint32 bits, same shape, any order,
duplicates allowed; ``inc=None`` adds 1 per position). Positions are
narrow, int32 holding uint32 bits with the sentinel 0xFFFFFFFF, or wide,
int64 with the sentinel -1 (a filter of exactly 2**32 counters; the direct
kernel's wide instantiation, counted as ``WIDE_KERNEL``). The sentinel, a
zero increment and a word index past the array are no-ops;
no lane carries into its neighbour. It updates ``words`` (int32 [nwords])
in place and returns it. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises, by one of three routes chosen by
``route(nwords, npos, weighted, wide)``: ``scatter_add_direct`` (one CAS
per pair) or, for unit increments only, ``scatter_add_tiled`` (the tile
partition of ``kernels/tile_partition.py``, then the positions applied tile
by tile, all in one call of the library) up to the partition's
``MAX_TILES`` tiles, and for wide positions ``scatter_add_sparse`` (the
partition on coarse tiles, then each coarse tile's positions sorted and one
clamped CAS a distinct word, in address order; one call too, counted as
``SPARSE_WIDE_KERNEL``). No path of the repo adds weighted increments on
the card, so only the direct route takes them. An array of 2**32 counters
has 2**30 words or more, past the tiles a partition takes: the direct or
the sparse route. Narrow positions past the partition's tiles (u8 filters
of 2**31 to 2**32 - 1 counters) take the direct route.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build, tile_partition

ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_uint]
KERNEL = _build.CudaKernel("btl_scatter_add", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_scatter_add_wide", ARGS)
TILED_KERNEL = _build.CudaKernel("btl_scatter_add_tiled", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_uint, ctypes.c_void_p],
    also=(tile_partition.KERNEL,))
SPARSE_WIDE_KERNEL = _build.CudaKernel("btl_scatter_add_sparse_wide", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p],
    also=(tile_partition.WIDE_KERNEL,))

# The route rule's constants, from H100 runs of tools/time_kernels.py's
# grid (uniform positions; PERF.md section 6): the sweep reads and writes
# the whole array, so it pays where the pairs are enough to amortise the
# partition and at least one pair comes for every 16 words. At 2M pairs it
# wins up to 2**25 words and loses from 2**26; at 3M it wins up to 2**25
# and ties at 2**26; at 1.5M it loses from 2**23 words up, where the
# direct CAS is the faster.
TILED_MIN_POS = 2 << 20
TILED_WORDS_PER_POS = 16
# Wide positions (2**32 counters, past the partition's tiles) take the
# sparse route where there is a pair for every SPARSE_WORDS_PER_POS words
# or fewer (tools/time_kernels.py's wide grid, PERF.md section 6): into
# 2**32 u8 counters 8M pairs (128 words a pair) tie, 12M win by 9%,
# bench.py's counting batch (24.8M) by 26%, 6M lose by 6%.
SPARSE_WORDS_PER_POS = 128


def route(nwords: int, npos: int, weighted: bool = False,
          wide: bool = False) -> str:
    """"tiled", "sparse" or "direct": the route a CUDA add of npos pairs
    into an array of nwords words takes (weighted: the increments are
    given; wide: the positions are int64)."""
    if weighted or npos >= 1 << 31:
        return "direct"
    if tile_partition.ntiles(nwords) > tile_partition.MAX_TILES:
        return ("sparse" if wide and nwords <= SPARSE_WORDS_PER_POS * npos
                else "direct")
    if TILED_MIN_POS <= npos and nwords <= TILED_WORDS_PER_POS * npos:
        return "tiled"
    return "direct"


def _check(words: torch.Tensor, pos: torch.Tensor, shift: int,
           counter_max: int, inc) -> None:
    if words.dtype != torch.int32:
        raise TypeError("words must be torch.int32 (uint32 bits)")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits) or int64")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")
    if shift not in (0, 1, 2):
        raise ValueError(f"shift must be 0, 1 or 2, got {shift}")
    if not 0 <= counter_max < (1 << (32 >> shift)):
        raise ValueError(f"counter_max {counter_max} does not fit a "
                         f"{32 >> shift}-bit lane")
    if inc is not None and (inc.dtype != torch.int32
                            or inc.shape != pos.shape):
        raise TypeError("inc must be torch.int32 (uint32 bits) shaped "
                        "like pos")


def scatter_add_plain(words: torch.Tensor, pos: torch.Tensor, shift: int,
                      counter_max: int, inc=None) -> torch.Tensor:
    """Sum the increments of each distinct counter, add the sums with
    saturation, and add each word's lane deltas at once: a lane never
    passes counter_max, so the deltas of one word compose without carries."""
    _check(words, pos, shift, counter_max, inc)
    p = u64.positions64(pos.reshape(-1))
    c = (torch.ones_like(p) if inc is None
         else u64.from_u32_bits(inc.reshape(-1)))
    keep = (p >= 0) & (c != 0) & ((p >> shift) < words.numel())
    p, c = p[keep], c[keep]
    uniq, inv = torch.unique(p, return_inverse=True)
    total = torch.zeros_like(uniq).index_add_(0, inv, c)
    bits = 32 >> shift
    lane = (uniq & ((1 << shift) - 1)) * bits
    w = uniq >> shift
    cur = (u64.from_u32_bits(words[w]) >> lane) & ((1 << bits) - 1)
    new = torch.where(cur >= counter_max, cur,
                      torch.clamp(cur + total, max=counter_max))
    uw, winv = torch.unique_consecutive(w, return_inverse=True)
    delta = torch.zeros_like(uw).index_add_(0, winv, (new - cur) << lane)
    words[uw] = u64.to_u32_bits(u64.from_u32_bits(words[uw]) + delta)
    return words


def scatter_add(words: torch.Tensor, pos: torch.Tensor, shift: int,
                counter_max: int, inc=None) -> torch.Tensor:
    _check(words, pos, shift, counter_max, inc)
    if _build.on_cpu(words, pos, *([] if inc is None else [inc])):
        return scatter_add_plain(words, pos, shift, counter_max, inc)
    way = route(words.numel(), pos.numel(), inc is not None,
                pos.dtype == torch.int64)
    if way == "tiled" and pos.dtype == torch.int32:
        return scatter_add_tiled(words, pos, shift, counter_max)
    if way == "sparse":
        return scatter_add_sparse(words, pos, shift, counter_max)
    return scatter_add_direct(words, pos, shift, counter_max, inc)


def scatter_add_direct(words: torch.Tensor, pos: torch.Tensor, shift: int,
                       counter_max: int, inc=None) -> torch.Tensor:
    """The direct route on a CUDA tensor, whatever the rule says."""
    _check(words, pos, shift, counter_max, inc)
    if _build.on_cpu(words, pos, *([] if inc is None else [inc])):
        return scatter_add_plain(words, pos, shift, counter_max, inc)
    pos = pos.reshape(-1).contiguous()
    if inc is not None:
        inc = inc.reshape(-1).contiguous()
    if pos.numel():
        kernel = WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL
        kernel.launch(words.device, _build.ptr(pos),
                      None if inc is None else _build.ptr(inc), pos.numel(),
                      _build.ptr(words), words.numel(), shift, counter_max)
    return words


def scatter_add_tiled(words: torch.Tensor, pos: torch.Tensor, shift: int,
                      counter_max: int) -> torch.Tensor:
    """The tiled route of unit increments on a CUDA tensor, whatever the
    rule says."""
    _check(words, pos, shift, counter_max, None)
    if _build.on_cpu(words, pos):
        return scatter_add_plain(words, pos, shift, counter_max)
    if pos.dtype != torch.int32:
        raise TypeError("the tiled route takes narrow positions (int32): "
                        "an array of 2**32 counters has more tiles than a "
                        "partition takes")
    pos = pos.reshape(-1).contiguous()
    if pos.numel() >= 1 << 31:
        raise ValueError("the tiled route takes fewer than 2**31 positions")
    if pos.numel():
        buf = tile_partition.scratch(pos.numel(), words.numel(),
                                     words.device)
        TILED_KERNEL.launch(words.device, _build.ptr(pos), pos.numel(),
                            _build.ptr(words), words.numel(), shift,
                            counter_max, _build.ptr(buf))
    return words


def scatter_add_sparse(words: torch.Tensor, pos: torch.Tensor, shift: int,
                       counter_max: int) -> torch.Tensor:
    """The sparse route of unit increments on a CUDA tensor, whatever the
    rule says (any array size: below MAX_TILES tiles its coarse tiles are
    the tiles)."""
    _check(words, pos, shift, counter_max, None)
    if _build.on_cpu(words, pos):
        return scatter_add_plain(words, pos, shift, counter_max)
    if pos.dtype != torch.int64:
        raise TypeError("the sparse route takes wide positions (int64): "
                        "narrow ones fit the tiled or the direct route")
    pos = pos.reshape(-1).contiguous()
    if pos.numel() >= 1 << 31:
        raise ValueError("the sparse route takes fewer than 2**31 positions")
    if pos.numel():
        extra, buf = tile_partition.coarse_scratch(
            pos.numel(), words.numel(), words.device)
        SPARSE_WIDE_KERNEL.launch(words.device, _build.ptr(pos), pos.numel(),
                                  _build.ptr(words), words.numel(), shift,
                                  counter_max, extra, _build.ptr(buf))
    return words
