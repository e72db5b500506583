"""Tile partition: the CUDA kernel ``csrc/tile_partition.cu`` and its plain
PyTorch version, the first stage of the tiled scatters
(``kernels/scatter_or.py``, ``kernels/scatter_add.py``).

``tile_partition(pos, nwords, word_shift)`` groups the live positions p of
``pos`` (any shape) by tile ``(p >> word_shift) >> TILE_SHIFT`` of an array
of ``nwords`` words, dropping the sentinel and positions whose word ``p >>
word_shift`` is past the array. Positions are narrow, int32 holding uint32
bits with the sentinel 0xFFFFFFFF, or wide, int64 with the sentinel -1
(Bloom filters from 2**32 bits; the kernel's wide instantiation counts as
``WIDE_KERNEL``). It returns ``(offsets, grouped)``: offsets int32 [ntiles
+ 1], the exclusive scan of the tile counts (``offsets[-1]`` the number of
live positions); grouped int32 [n], the low 32 bits of tile t's positions
in ``grouped[offsets[t]:offsets[t + 1]]`` in no set order (a tile spans a
power of two positions that divides 2**32, so the tile gives the rest).
Entries of grouped from ``offsets[-1]`` on are unspecified (the plain
version writes -1).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import os
import re

import torch

from ..ops import u64
from . import _build


def _define(name: str) -> int:
    """A numeric ``#define`` of ``csrc/tile_partition.cuh``: the tile
    constants are written there once, with their reasons."""
    with open(os.path.join(_build.CSRC, "tile_partition.cuh")) as f:
        return int(re.search(rf"^#define {name} (\d+)$", f.read(),
                             re.M).group(1))


# Words of a tile of the tiled scatters, as a shift, and the most tiles a
# partition takes.
TILE_SHIFT = _define("BTL_TILE_SHIFT")
MAX_TILES = _define("BTL_MAX_TILES")

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
KERNEL = _build.CudaKernel("btl_tile_partition", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_tile_partition_wide", ARGS)

# The kernel's second pass takes the tile index's low 7 bits (LOW_BITS in
# csrc/tile_partition.cu) from a wide position's low 32 bits.
_WIDE_MAX_SHIFT = 32 - 7

_scratch_words = None


def ntiles(nwords: int, tile_shift: int = TILE_SHIFT) -> int:
    return -(-nwords >> tile_shift)


def coarse_shift(nwords: int, tile_shift: int = TILE_SHIFT,
                 max_tiles: int = MAX_TILES) -> int:
    """The least ``extra`` >= 0 that brings an array of nwords words to at
    most max_tiles tiles of 2**(tile_shift + extra) words: the coarse tiles
    incrementAll's sparse route partitions by (0 up to max_tiles tiles)."""
    extra = 0
    while ntiles(nwords, tile_shift + extra) > max_tiles:
        extra += 1
    return extra


def coarse_words(nwords: int, extra: int) -> int:
    """Coarse words of 2**extra words each: the array the sparse route
    hands the partition (``btl_coarse_words`` in csrc/tile_partition.cuh)."""
    return -(-nwords >> extra)


def coarse_scratch(n: int, nwords: int, device):
    """``(extra, scratch)`` of a sparse route call: the coarse shift of
    an array of nwords words and the partition's scratch for n positions
    into its coarse words."""
    extra = coarse_shift(nwords)
    return extra, scratch(n, coarse_words(nwords, extra), device)


def padded_tiles(nwords: int) -> int:
    """The tile count rounded up to a power of two: the length, less one,
    of the offsets at the head of the scratch."""
    return 1 << (ntiles(nwords) - 1).bit_length()


def scratch(n: int, nwords: int, device) -> torch.Tensor:
    """One int32 buffer as ``btl_tile_partition_run`` takes it: offsets
    [padded_tiles + 1], grouped positions [n], then the partition's own
    working space."""
    global _scratch_words
    if _scratch_words is None:
        fn = _build.library().btl_tile_partition_scratch
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
        _scratch_words = fn
    return torch.empty(_scratch_words(n, nwords), dtype=torch.int32,
                       device=device)


def _check(pos: torch.Tensor, nwords: int, word_shift: int,
           tile_shift: int) -> int:
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits) or int64")
    if not 0 <= word_shift < 32 or not 0 <= tile_shift < 32:
        raise ValueError("word_shift and tile_shift must be in [0, 32)")
    if pos.dtype == torch.int64 and word_shift + tile_shift > _WIDE_MAX_SHIFT:
        raise ValueError("wide positions need word_shift + tile_shift <= "
                         f"{_WIDE_MAX_SHIFT}")
    nt = ntiles(nwords, tile_shift)
    if not 1 <= nt <= MAX_TILES:
        raise ValueError(f"{nt} tiles: a partition takes 1 to {MAX_TILES}")
    if pos.numel() >= 1 << 31:
        raise ValueError("a partition takes fewer than 2**31 positions")
    return nt


def tile_partition_plain(pos: torch.Tensor, nwords: int, word_shift: int,
                         tile_shift: int = TILE_SHIFT):
    """A stable argsort on the tile index. ``tile_shift`` other than
    TILE_SHIFT serves the CPU models of the tiled routes at small sizes."""
    nt = _check(pos, nwords, word_shift, tile_shift)
    p = u64.positions64(pos.reshape(-1))
    p = p[(p >= 0) & ((p >> word_shift) < nwords)]
    tile = (p >> word_shift) >> tile_shift
    order = torch.argsort(tile, stable=True)
    offsets = torch.zeros(nt + 1, dtype=torch.int64, device=pos.device)
    offsets[1:] = torch.cumsum(torch.bincount(tile, minlength=nt), 0)
    grouped = torch.full((pos.numel(),), -1, dtype=torch.int32,
                         device=pos.device)
    grouped[:tile.numel()] = u64.to_u32_bits(p[order] & 0xFFFFFFFF)
    return offsets.to(torch.int32), grouped


def tile_partition(pos: torch.Tensor, nwords: int, word_shift: int):
    nt = _check(pos, nwords, word_shift, TILE_SHIFT)
    if _build.on_cpu(pos):
        return tile_partition_plain(pos, nwords, word_shift)
    pos = pos.reshape(-1).contiguous()
    n = pos.numel()
    buf = scratch(n, nwords, pos.device)
    kernel = WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL
    kernel.launch(pos.device, _build.ptr(pos), n, nwords, word_shift,
                  _build.ptr(buf))
    at = padded_tiles(nwords) + 1
    return buf[:nt + 1], buf[at:at + n]
