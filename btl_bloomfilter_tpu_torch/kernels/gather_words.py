"""Bloom query of position planes: the CUDA kernel ``csrc/gather_words.cu``
and its plain PyTorch version.

``gather_words(words, pos)`` takes positions [h, ...] (plane-major as the
ntHash kernel writes them) and returns hit bool [...]: True where all h
bits ``words[p >> 5] >> (p & 31)`` are set and slot 0 is not the sentinel.
Positions are narrow, int32 holding uint32 bits with the sentinel
0xFFFFFFFF, or wide, int64 with the sentinel -1 (filters from 2**32 bits;
the kernel's wide instantiation counts as ``WIDE_KERNEL``). A sentinel in
another slot reads bit 0, and a word index past the filter is clamped to
the last word, as the reference's XLA gather does. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p]
KERNEL = _build.CudaKernel("btl_gather_words", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_gather_words_wide", ARGS)


def _check(words: torch.Tensor, pos: torch.Tensor) -> None:
    if words.dtype != torch.int32:
        raise TypeError("words must be torch.int32 (uint32 bits)")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits) or int64")
    if words.dim() != 1 or words.numel() == 0:
        raise ValueError("words must be a non-empty 1-D tensor")
    if pos.dim() < 1 or pos.shape[0] < 1:
        raise ValueError("pos must be [h, ...] with h >= 1")


def gather_words_plain(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    _check(words, pos)
    p = u64.positions64(pos)
    valid = p[0] >= 0
    p = p.clamp(min=0)
    w = (p >> 5).clamp(max=words.numel() - 1)
    bits = (u64.from_u32_bits(words[w]) >> (p & 31)) & 1
    return (bits == 1).all(dim=0) & valid


def gather_words(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    _check(words, pos)
    if _build.on_cpu(words, pos):
        return gather_words_plain(words, pos)
    h = pos.shape[0]
    pos = pos.contiguous()
    words = words.contiguous()
    hit = torch.empty(pos.shape[1:], dtype=torch.bool, device=pos.device)
    n = hit.numel()
    if n:
        kernel = WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL
        kernel.launch(pos.device, pos.data_ptr(), n, h, words.data_ptr(),
                      words.numel(), hit.data_ptr())
    return hit
