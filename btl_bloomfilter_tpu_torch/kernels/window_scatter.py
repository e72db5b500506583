"""Static-window Bloom scatter: the CUDA kernel ``csrc/window_scatter.cu``
and its plain PyTorch version, the port of the kernel behind
``bench/kernel_lab.py:build`` (the kernel lab probe,
``probes/kernel_lab.py``, calls it).

``window_scatter(idx, pos, words, scatter)``: the filter ``words`` (int32
holding uint32 bits, ``nwin * WIN_WORDS`` words, any shape) is cut into
``WIN_WORDS``-word windows. For each window w, the bits of the positions of
the chunks ``idx[s, w]`` (idx int32 [slots, nwin]; chunk c is
``pos[c * CHUNK:(c + 1) * CHUNK]`` of the sorted positions) whose word lies
in w are ORed into the window; the sentinel 0xFFFFFFFF, a chunk index
outside the positions, and positions no chunk of their window reaches
contribute nothing. ``scatter=False`` is the probe's ``null`` variant: the
windows are loaded and stored unchanged. ``words`` is updated in place and
returned. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build, scatter_or
from ._build import SENTINEL

WIN_WORDS = 16384        # words per window (64 KiB)
CHUNK = 1024             # positions per chunk

KERNEL = _build.CudaKernel("btl_window_scatter", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int])


def _check(idx: torch.Tensor, pos: torch.Tensor, words: torch.Tensor):
    if (idx.dtype, pos.dtype, words.dtype) != (torch.int32,) * 3:
        raise TypeError("idx, pos and words must be torch.int32")
    if not words.is_contiguous() or words.numel() % WIN_WORDS:
        raise ValueError(f"words must be contiguous, a multiple of "
                         f"{WIN_WORDS} words")
    nwin = words.numel() // WIN_WORDS
    if idx.dim() != 2 or idx.shape[1] != nwin:
        raise ValueError(f"idx must be [slots, {nwin}], got "
                         f"{tuple(idx.shape)}")
    if pos.dim() != 1 or pos.numel() % CHUNK:
        raise ValueError(f"pos must be 1-D, a multiple of {CHUNK} long")


def window_scatter_plain(idx: torch.Tensor, pos: torch.Tensor,
                         words: torch.Tensor,
                         scatter: bool = True) -> torch.Tensor:
    """Every (slot, window) pair's chunk at once; a chunk equal to its
    predecessor slot is not skipped here, which changes nothing (OR is
    idempotent)."""
    _check(idx, pos, words)
    nwin, nchunks = words.numel() // WIN_WORDS, pos.numel() // CHUNK
    if not scatter or nchunks == 0:
        return words
    c = idx.to(torch.int64)
    ok = (c >= 0) & (c < nchunks)
    p = u64.from_u32_bits(pos.reshape(nchunks, CHUNK)[c.clamp(0, nchunks - 1)])
    w = torch.arange(nwin, device=words.device)[None, :, None]
    live = ok[..., None] & (p != SENTINEL) & ((p >> 5) // WIN_WORDS == w)
    scatter_or.scatter_or_plain(words.view(-1),
                                u64.to_u32_bits(torch.where(live, p,
                                                            SENTINEL)))
    return words


def window_scatter(idx: torch.Tensor, pos: torch.Tensor, words: torch.Tensor,
                   scatter: bool = True) -> torch.Tensor:
    _check(idx, pos, words)
    if _build.on_cpu(idx, pos, words):
        return window_scatter_plain(idx, pos, words, scatter)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    nwin = words.numel() // WIN_WORDS
    if nwin:
        idx, pos = idx.contiguous(), pos.contiguous()
        if pos.data_ptr() % 16:     # the kernel reads 16-byte vectors
            pos = pos.clone()
        KERNEL.launch(words.device, _build.ptr(idx), idx.shape[0], nwin,
                      _build.ptr(pos), pos.numel() // CHUNK,
                      _build.ptr(words), int(scatter))
    return words
