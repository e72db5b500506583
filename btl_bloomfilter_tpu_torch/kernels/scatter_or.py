"""Bloom insert of bit positions: the CUDA kernels ``csrc/scatter_or.cu``
and ``csrc/scatter_or_sorted.cu`` and their plain PyTorch version.

``scatter_or(words, pos)`` sets bit ``p & 31`` of ``words[p >> 5]`` for
every position p (any shape, any order, duplicates allowed), skipping the
sentinel and positions past the filter. Positions come in the narrow form,
int32 holding uint32 bits with the sentinel 0xFFFFFFFF (filters below
2**32 bits), or the wide one, int64 with the sentinel -1 (filters from
2**32 to 2**36 bits), which launches the ``*_wide`` entry points and
counts as ``WIDE_KERNEL`` / ``TILED_WIDE_KERNEL``. It updates ``words``
(int32 [nwords]) in place and returns it. On a CUDA tensor it takes one of
two routes, by ``route(nwords, npos)``: ``scatter_or_direct`` (one
atomicOr per position) or ``scatter_or_tiled`` (the tile partition of
``kernels/tile_partition.py``, then the positions applied tile by tile,
all in one call of the library).

``scatter_or_sorted(words, pos_sorted, pos_for_base=None)`` is the same
insert for sorted narrow positions, the port of the JAX package's
``kernels/scatter_or.py:scatter_or_sorted``: one atomic per run of equal
words instead of one per position. It updates ``words`` in place and
returns ``(words, overflow)``; the overflow is always 0 (Hopper has no
window to overflow, every position is applied), and ``pos_for_base``,
which places the TPU's windows, is accepted and ignored.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from ..utils import trace
from . import _build, tile_partition

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong]
KERNEL = _build.CudaKernel("btl_scatter_or", ARGS)
SORTED_KERNEL = _build.CudaKernel("btl_scatter_or_sorted", ARGS)
TILED_KERNEL = _build.CudaKernel("btl_scatter_or_tiled",
                                 ARGS + [ctypes.c_void_p],
                                 also=(tile_partition.KERNEL,))
WIDE_KERNEL = _build.CudaKernel("btl_scatter_or_wide", ARGS)
TILED_WIDE_KERNEL = _build.CudaKernel("btl_scatter_or_tiled_wide",
                                      ARGS + [ctypes.c_void_p],
                                      also=(tile_partition.WIDE_KERNEL,))

# The route rule's constants, from H100 runs of tools/time_kernels.py's
# grid (uniform positions; PERF.md section 6): the tiled route pays once the
# filter outgrows the 50 MB L2 (from 2**24 words, 64 MiB) and the positions
# are enough to amortise the partition and the sweep. At 2M positions it
# wins for 2**24 to 2**26 words and loses at 2**27, which takes 3M (one
# position in 48 words); at 1.5M it loses. The rule counts sentinels as
# positions: at bench.py's batch with 2% N (about 53% live) the two routes
# tie.
TILED_MIN_WORDS = 1 << 24
TILED_MIN_POS = 2 << 20
TILED_WORDS_PER_POS = 48


def route(nwords: int, npos: int) -> str:
    """"tiled" or "direct": the route a CUDA insert of npos positions into
    a filter of nwords words takes."""
    if (nwords >= TILED_MIN_WORDS and npos < 1 << 31
            and npos >= max(TILED_MIN_POS, nwords // TILED_WORDS_PER_POS)
            and tile_partition.ntiles(nwords) <= tile_partition.MAX_TILES):
        return "tiled"
    return "direct"


def _check(words: torch.Tensor, pos: torch.Tensor,
           wide: bool = True) -> None:
    if words.dtype != torch.int32:
        raise TypeError("words must be torch.int32 (uint32 bits)")
    if pos.dtype != torch.int32 and not (wide and pos.dtype == torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits)"
                        + (" or torch.int64" if wide else ""))
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D tensor")


def scatter_or_plain(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Deduplicate, then add one-bit masks by word: distinct bits of a word
    sum without carries, so the add is an OR. Only the words that gain a
    bit are touched (no delta the size of the filter)."""
    _check(words, pos)
    p = u64.positions64(pos.reshape(-1))
    p = torch.unique(p[p >= 0])
    w = p >> 5
    keep = w < words.numel()
    p, w = p[keep], w[keep]
    uw, inv = torch.unique_consecutive(w, return_inverse=True)
    delta = torch.zeros(uw.numel(), dtype=torch.int64,
                        device=words.device).index_add_(
        0, inv, torch.ones_like(p) << (p & 31))
    words[uw] |= u64.to_u32_bits(delta)
    return words


def launch(kernel: _build.CudaKernel, words: torch.Tensor,
           pos: torch.Tensor) -> None:
    """Launch ``kernel`` (a direct or sorted entry point above) on CUDA
    tensors."""
    _check(words, pos, kernel is WIDE_KERNEL)
    pos = pos.reshape(-1).contiguous()
    if pos.numel():
        kernel.launch(words.device, _build.ptr(pos), pos.numel(),
                      _build.ptr(words), words.numel())


def scatter_or(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The insert, in a ``btl.scatter.<route>`` span (``plain`` on the
    CPU); counts the call under ``route.<route>`` and, on the tiled route,
    the partition's tiles under ``tiles``."""
    if _build.on_cpu(words, pos):
        trace.count("route.plain")
        with trace.span("btl.scatter.plain"):
            return scatter_or_plain(words, pos)
    if route(words.numel(), pos.numel()) == "tiled":
        trace.count("route.tiled")
        trace.count("tiles", tile_partition.ntiles(words.numel()))
        with trace.span("btl.scatter.tiled"):
            return scatter_or_tiled(words, pos)
    trace.count("route.direct")
    with trace.span("btl.scatter.direct"):
        return scatter_or_direct(words, pos)


def scatter_or_direct(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The direct route on a CUDA tensor, whatever the rule says."""
    if _build.on_cpu(words, pos):
        return scatter_or_plain(words, pos)
    launch(WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL, words, pos)
    return words


def scatter_or_tiled(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The tiled route on a CUDA tensor, whatever the rule says."""
    if _build.on_cpu(words, pos):
        return scatter_or_plain(words, pos)
    _check(words, pos)
    pos = pos.reshape(-1).contiguous()
    if pos.numel() >= 1 << 31:
        raise ValueError("the tiled route takes fewer than 2**31 positions")
    if tile_partition.ntiles(words.numel()) > tile_partition.MAX_TILES:
        raise ValueError(f"the tiled route takes at most "
                         f"{tile_partition.MAX_TILES} tiles")
    if pos.numel():
        buf = tile_partition.scratch(pos.numel(), words.numel(),
                                     words.device)
        kernel = (TILED_WIDE_KERNEL if pos.dtype == torch.int64
                  else TILED_KERNEL)
        kernel.launch(words.device, _build.ptr(pos), pos.numel(),
                      _build.ptr(words), words.numel(), _build.ptr(buf))
    return words


def scatter_or_sorted_plain(words: torch.Tensor, pos_sorted: torch.Tensor,
                            pos_for_base: torch.Tensor | None = None):
    del pos_for_base
    return scatter_or_plain(words, pos_sorted), 0


def scatter_or_sorted(words: torch.Tensor, pos_sorted: torch.Tensor,
                      pos_for_base: torch.Tensor | None = None):
    del pos_for_base
    if _build.on_cpu(words, pos_sorted):
        return scatter_or_sorted_plain(words, pos_sorted)
    launch(SORTED_KERNEL, words, pos_sorted)
    return words, 0
