"""Saturating add into packed counters: the CUDA kernel
``csrc/scatter_add.cu`` and its plain PyTorch version.

``scatter_add(words, pos, shift, counter_max, inc=None)`` sets counter p
(lane ``p & (per - 1)`` of ``words[p >> shift]``, ``per = 1 << shift``) to
``min(counter + inc, counter_max)`` for every pair of position p and
increment inc (int32 holding uint32 bits, same shape, any order,
duplicates allowed; ``inc=None`` adds 1 per position). The sentinel
0xFFFFFFFF, a zero increment and a word index past the array are no-ops;
no lane carries into its neighbour. It updates ``words`` (int32 [nwords])
in place and returns it. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build
from ._build import SENTINEL

KERNEL = _build.CudaKernel("btl_scatter_add", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_uint])


def _check(words: torch.Tensor, pos: torch.Tensor, shift: int,
           counter_max: int, inc) -> None:
    if words.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("words and pos must be torch.int32 (uint32 bits)")
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
    p = u64.from_u32_bits(pos.reshape(-1))
    c = (torch.ones_like(p) if inc is None
         else u64.from_u32_bits(inc.reshape(-1)))
    keep = (p != SENTINEL) & (c != 0) & ((p >> shift) < words.numel())
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
    pos = pos.reshape(-1).contiguous()
    if inc is not None:
        inc = inc.reshape(-1).contiguous()
    if pos.numel():
        KERNEL.launch(words.device, _build.ptr(pos),
                      None if inc is None else _build.ptr(inc), pos.numel(),
                      _build.ptr(words), words.numel(), shift, counter_max)
    return words
