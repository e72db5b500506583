"""Counting-filter read of position planes: the CUDA kernel
``csrc/gather_counters.cu`` and its plain PyTorch version.

``gather_counters(words, pos, shift, out, threshold)`` reads packed
counters: counter p is lane ``p & (per - 1)`` of ``words[p >> shift]``,
``per = 1 << shift`` counters per word (shift 0, 1 or 2: 32-, 16- or 8-bit
lanes, little-endian within the word). Positions are [h, ...], plane-major
as the ntHash kernel writes them: narrow, int32 holding uint32 bits with
the sentinel 0xFFFFFFFF, or wide, int64 with the sentinel -1 (a filter of
exactly 2**32 counters, where 0xFFFFFFFF is a real counter; the kernel's
wide instantiation counts as ``WIDE_KERNEL``). ``out`` picks what it
returns:

  * ``"vals"``: the counter values [h, ...] as int64 (a sentinel slot
    reads 0);
  * ``"min"``: their minimum over h [...] as int64 (0 where slot 0 is the
    sentinel, which marks an invalid window);
  * ``"hit"``: bool [...], slot 0 not the sentinel and min >= threshold.

A word index past the array is clamped to the last word, as the
reference's XLA gather does. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
KERNEL = _build.CudaKernel("btl_gather_counters", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_gather_counters_wide", ARGS)

OUTPUTS = ("vals", "min", "hit")


def _check(words: torch.Tensor, pos: torch.Tensor, shift: int, out: str,
           threshold: int) -> None:
    if words.dtype != torch.int32:
        raise TypeError("words must be torch.int32 (uint32 bits)")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits) or int64")
    if words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D tensor")
    if pos.dim() < 1 or pos.shape[0] < 1:
        raise ValueError("pos must be [h, ...] with h >= 1")
    if shift not in (0, 1, 2):
        raise ValueError(f"shift must be 0, 1 or 2, got {shift}")
    if out not in OUTPUTS:
        raise ValueError(f"out must be one of {OUTPUTS}, got {out!r}")
    if not 0 <= threshold < (1 << 64):
        raise ValueError(f"threshold {threshold} outside [0, 2**64)")


def lane_values(words: torch.Tensor, p: torch.Tensor,
                shift: int) -> torch.Tensor:
    """Counters at indices p (int64) of packed words, as int64: the word
    gather and lane extract of the reference's ``_gather_lane_xla``; the
    word index is clamped to the last word."""
    bits = 32 >> shift
    w = (p >> shift).clamp(max=words.numel() - 1)
    return (u64.from_u32_bits(words[w]) >> ((p & ((1 << shift) - 1)) * bits)
            ) & ((1 << bits) - 1)


def gather_counters_plain(words: torch.Tensor, pos: torch.Tensor, shift: int,
                          out: str = "min",
                          threshold: int = 0) -> torch.Tensor:
    _check(words, pos, shift, out, threshold)
    p = u64.positions64(pos)
    sent = p < 0
    vals = torch.where(sent, 0, lane_values(words, torch.where(sent, 0, p),
                                            shift))
    if out == "vals":
        return vals
    valid = ~sent[0]
    mins = torch.where(valid, vals.amin(dim=0), 0)
    if out == "min":
        return mins
    return valid & (mins >= threshold)


def gather_counters(words: torch.Tensor, pos: torch.Tensor, shift: int,
                    out: str = "min", threshold: int = 0) -> torch.Tensor:
    _check(words, pos, shift, out, threshold)
    if _build.on_cpu(words, pos):
        return gather_counters_plain(words, pos, shift, out, threshold)
    pos = pos.contiguous()
    words = words.contiguous()
    shape = pos.shape if out == "vals" else pos.shape[1:]
    res = torch.empty(shape, dtype=torch.bool if out == "hit"
                      else torch.int32, device=pos.device)
    n = pos[0].numel()
    if n:
        ptrs = [_build.ptr(res) if name == out else None for name in OUTPUTS]
        kernel = WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL
        kernel.launch(pos.device, _build.ptr(pos), n, pos.shape[0],
                      _build.ptr(words), words.numel(), shift, threshold,
                      *ptrs)
    return res if out == "hit" else u64.from_u32_bits(res)
