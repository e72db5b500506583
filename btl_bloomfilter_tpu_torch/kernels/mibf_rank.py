"""MIBF rank (+ ID) lookup of bit positions: the CUDA kernel
``csrc/mibf_rank.cu`` and its plain PyTorch version.

``rank_lookup(bv_words, cum_ranks, pos, data=None)`` takes positions int32
[...] (uint32 bits, each < the vector's size) and returns (rank int32,
hit bool, raw int32 or None), all shaped like pos:

  * rank = cum_ranks[p >> 5] + popcount(bv_words[p >> 5] & ((1 << (p & 31))
    - 1)): the number of set bits before p (sdsl rank);
  * hit  = bit p is set;
  * raw  = data[min(rank, d_size - 1)] where hit, else 0, as uint32 bits:
    the ID with its saturation and strand bits. Only when ``data`` (the ID
    plane, uint8 / int16 / int32 bit patterns for widths 1 / 2 / 4) is
    given: construction needs ranks only.

A word index past the vector is clamped to its last word. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build

KERNEL = _build.CudaKernel("btl_mibf_rank", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

_ID_DTYPES = (torch.uint8, torch.int16, torch.int32)   # widths 1, 2, 4


def _check(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
           pos: torch.Tensor, data) -> None:
    if (bv_words.dtype != torch.int32 or cum_ranks.dtype != torch.int32
            or pos.dtype != torch.int32):
        raise TypeError("bv_words, cum_ranks and pos must be torch.int32 "
                        "(uint32 bits)")
    if bv_words.dim() != 1 or bv_words.numel() == 0 \
            or cum_ranks.shape != bv_words.shape:
        raise ValueError("bv_words and cum_ranks must be non-empty 1-D "
                         "tensors of one length")
    if data is not None:
        if data.dtype not in _ID_DTYPES or data.dim() != 1:
            raise TypeError("data must be a 1-D uint8, int16 or int32 tensor")
        if data.numel() >= (1 << 31):
            raise ValueError("ID planes of 2**31 entries or more are not "
                             "supported (ranks are int32)")


def rank_lookup_plain(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
                      pos: torch.Tensor, data=None):
    _check(bv_words, cum_ranks, pos, data)
    p = u64.from_u32_bits(pos)
    w = (p >> 5).clamp(max=bv_words.numel() - 1)
    bit = p & 31
    word = u64.from_u32_bits(bv_words[w])
    rank = u64.from_u32_bits(cum_ranks[w]) + u64.popcount32(
        word & ((1 << bit) - 1))
    hit = ((word >> bit) & 1) == 1
    raw = None
    if data is not None:
        if data.numel():
            vals = u64.unsigned(data[rank.clamp(max=data.numel() - 1)])
            raw = u64.to_u32_bits(torch.where(hit, vals, 0))
        else:
            raw = torch.zeros_like(pos)
    return rank.to(torch.int32), hit, raw


def rank_lookup(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
                pos: torch.Tensor, data=None):
    _check(bv_words, cum_ranks, pos, data)
    tensors = (bv_words, cum_ranks, pos) + (() if data is None else (data,))
    if _build.on_cpu(*tensors):
        return rank_lookup_plain(bv_words, cum_ranks, pos, data)
    dev = pos.device
    pos = pos.contiguous()
    rank = torch.empty(pos.shape, dtype=torch.int32, device=dev)
    hit = torch.empty(pos.shape, dtype=torch.bool, device=dev)
    raw = None if data is None else torch.empty_like(pos)
    n = pos.numel()
    if n:
        bv_words, cum_ranks = bv_words.contiguous(), cum_ranks.contiguous()
        if data is not None:
            data = data.contiguous()
        null = ctypes.c_void_p(None)
        KERNEL.launch(
            dev, _build.ptr(pos), n, _build.ptr(bv_words),
            _build.ptr(cum_ranks), bv_words.numel(),
            null if data is None else _build.ptr(data),
            0 if data is None else data.element_size(),
            0 if data is None else data.numel(), _build.ptr(rank),
            _build.ptr(hit), null if raw is None else _build.ptr(raw))
    return rank, hit, raw
