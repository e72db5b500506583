"""MIBF rank (+ ID) lookup of bit positions: the CUDA kernel
``csrc/mibf_rank.cu`` and its plain PyTorch version.

``rank_lookup(bv_words, cum_ranks, rank_dir, pos, data=None)`` takes
positions int32 [...] (uint32 bits, each < the vector's size) and returns
(rank int32, hit bool, raw int32 / int64 or None), all shaped like pos:

  * rank = cum_ranks[p >> 5] + popcount(bv_words[p >> 5] & ((1 << (p & 31))
    - 1)): the number of set bits before p (sdsl rank);
  * hit  = bit p is set;
  * raw  = data[min(rank, d_size - 1)] where hit, else 0: the ID with its
    saturation and strand bits, as int32 holding uint32 bits, or at width 8
    as int64 holding the uint64 bits. Only when ``data`` (the ID plane,
    uint8 / int16 / int32 / int64 bit patterns for widths 1 / 2 / 4 / 8) is
    given: construction needs ranks only. The width-8 form is the kernel's
    uint64 instantiation and counts its launches as ``U64_KERNEL``.

A word index past the vector is clamped to its last word.

``rank_dir`` is the rank directory of ``rank_directory(bv_words,
cum_ranks)``: int32 [8 * ceil(nwords / 7)], one 32-byte block a 7 words,
the cumulative count of the block's first word and then its 7 words (zero
past the vector), so that a lookup reads one sector. The kernel reads only
the directory; the plain version ``rank_lookup_plain`` reads only
``bv_words`` and ``cum_ranks``, so the two check each other, and
``rank_lookup_dir_plain`` (the directory's arithmetic in torch) holds the
layout against it on the CPU. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
KERNEL = _build.CudaKernel("btl_mibf_rank", ARGS)
U64_KERNEL = _build.CudaKernel("btl_mibf_rank", ARGS)    # width 8

# words of the bit vector a directory block holds, and its int32 entries
BLOCK_WORDS, BLOCK = 7, 8

# widths 1, 2, 4, 8
_ID_DTYPES = (torch.uint8, torch.int16, torch.int32, torch.int64)


def rank_directory(bv_words: torch.Tensor,
                   cum_ranks: torch.Tensor) -> torch.Tensor:
    """The rank directory of a frozen bit vector (see the module's
    docstring), on its device."""
    full, rest = divmod(bv_words.numel(), BLOCK_WORDS)
    d = torch.zeros(full + (rest > 0), BLOCK, dtype=torch.int32,
                    device=bv_words.device)
    d[:, 0] = cum_ranks[::BLOCK_WORDS]
    d[:full, 1:] = bv_words[:full * BLOCK_WORDS].view(full, BLOCK_WORDS)
    d[full:, 1:1 + rest] = bv_words[full * BLOCK_WORDS:]
    return d.view(-1)


def _check_dir(rank_dir: torch.Tensor, nwords: int) -> None:
    if rank_dir.dtype != torch.int32 or rank_dir.shape != (
            BLOCK * -(-nwords // BLOCK_WORDS),):
        raise ValueError("rank_dir must be the int32 rank directory of "
                         "the bit vector (rank_directory)")


def _check_ids(data) -> None:
    if data is not None:
        if data.dtype not in _ID_DTYPES or data.dim() != 1:
            raise TypeError("data must be a 1-D uint8, int16, int32 or "
                            "int64 tensor")
        if data.numel() >= (1 << 31):
            raise ValueError("ID planes of 2**31 entries or more are not "
                             "supported (ranks are int32)")


def _check(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
           rank_dir: torch.Tensor, pos: torch.Tensor, data) -> None:
    if (bv_words.dtype != torch.int32 or cum_ranks.dtype != torch.int32
            or pos.dtype != torch.int32):
        raise TypeError("bv_words, cum_ranks and pos must be torch.int32 "
                        "(uint32 bits)")
    if bv_words.dim() != 1 or bv_words.numel() == 0 \
            or cum_ranks.shape != bv_words.shape:
        raise ValueError("bv_words and cum_ranks must be non-empty 1-D "
                         "tensors of one length")
    if bv_words.numel() > 1 << 27:
        raise ValueError("bit vectors of more than 2**32 bits are not "
                         "supported (positions are uint32)")
    _check_dir(rank_dir, bv_words.numel())
    _check_ids(data)


def _ids(data, rank: torch.Tensor, hit: torch.Tensor, pos: torch.Tensor):
    """raw of the plain versions: data[min(rank, d_size - 1)] where hit,
    else 0, as uint32 bits (int64 at width 8)."""
    if data is None:
        return None
    wide = data.dtype == torch.int64
    if not data.numel():
        return torch.zeros(pos.shape, dtype=data.dtype if wide else pos.dtype,
                           device=pos.device)
    vals = torch.where(hit, u64.unsigned(
        data[rank.clamp(max=data.numel() - 1)]), 0)
    return vals if wide else u64.to_u32_bits(vals)


def rank_lookup_plain(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
                      rank_dir: torch.Tensor, pos: torch.Tensor, data=None):
    """The lookup from ``bv_words`` and ``cum_ranks``; ``rank_dir`` is
    checked and not read."""
    _check(bv_words, cum_ranks, rank_dir, pos, data)
    p = u64.from_u32_bits(pos)
    w = (p >> 5).clamp(max=bv_words.numel() - 1)
    bit = p & 31
    word = u64.from_u32_bits(bv_words[w])
    rank = u64.from_u32_bits(cum_ranks[w]) + u64.popcount32(
        word & ((1 << bit) - 1))
    hit = ((word >> bit) & 1) == 1
    return rank.to(torch.int32), hit, _ids(data, rank, hit, pos)


def rank_lookup_dir_plain(rank_dir: torch.Tensor, nwords: int,
                          pos: torch.Tensor, data=None):
    """The kernel's arithmetic in torch: the lookup through the directory
    of a bit vector of ``nwords`` words alone. Tests hold it against
    ``rank_lookup_plain``."""
    _check_dir(rank_dir, nwords)
    _check_ids(data)
    p = u64.from_u32_bits(pos)
    w = (p >> 5).clamp(max=nwords - 1)
    b, j = w // BLOCK_WORDS, w % BLOCK_WORDS
    blk = u64.from_u32_bits(rank_dir.reshape(-1, BLOCK)[b])
    before = torch.arange(BLOCK_WORDS, device=pos.device) < j[..., None]
    rank = blk[..., 0] + (u64.popcount32(blk[..., 1:]) * before).sum(-1)
    word = torch.gather(blk[..., 1:], -1, j[..., None])[..., 0]
    bit = p & 31
    rank = rank + u64.popcount32(word & ((1 << bit) - 1))
    hit = ((word >> bit) & 1) == 1
    return rank.to(torch.int32), hit, _ids(data, rank, hit, pos)


def rank_lookup(bv_words: torch.Tensor, cum_ranks: torch.Tensor,
                rank_dir: torch.Tensor, pos: torch.Tensor, data=None):
    _check(bv_words, cum_ranks, rank_dir, pos, data)
    tensors = (bv_words, cum_ranks, rank_dir, pos) + (
        () if data is None else (data,))
    if _build.on_cpu(*tensors):
        return rank_lookup_plain(bv_words, cum_ranks, rank_dir, pos, data)
    dev = pos.device
    pos = pos.contiguous()
    rank = torch.empty(pos.shape, dtype=torch.int32, device=dev)
    hit = torch.empty(pos.shape, dtype=torch.bool, device=dev)
    raw = None if data is None else torch.empty(
        pos.shape, dtype=torch.int64 if data.dtype == torch.int64
        else torch.int32, device=dev)
    n = pos.numel()
    if n:
        rank_dir = rank_dir.contiguous()
        if rank_dir.data_ptr() % 16:
            raise ValueError("rank_dir must be 16-byte aligned")
        if data is not None:
            data = data.contiguous()
        null = ctypes.c_void_p(None)
        kernel = U64_KERNEL if data is not None and \
            data.dtype == torch.int64 else KERNEL
        kernel.launch(
            dev, _build.ptr(pos), n, _build.ptr(rank_dir), bv_words.numel(),
            null if data is None else _build.ptr(data),
            0 if data is None else data.element_size(),
            0 if data is None else data.numel(), _build.ptr(rank),
            _build.ptr(hit), null if raw is None else _build.ptr(raw))
    return rank, hit, raw
