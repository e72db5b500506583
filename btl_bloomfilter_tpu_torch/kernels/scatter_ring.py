"""Bloom insert of sorted bit positions into a new filter: the CUDA kernel
``btl_scatter_or_sorted_delta`` of ``csrc/scatter_or_sorted.cu`` and its
plain PyTorch version.

``scatter_or_sorted(words, pos_sorted, pos_for_base=None)`` is the port of
the JAX package's ``kernels/scatter_ring.py:scatter_or_sorted``: it
returns ``(words | bits(pos_sorted), overflow)`` as a new tensor and leaves
``words`` untouched, as the JAX function's OR outside its Pallas kernel
does (positions int32 holding uint32 bits; the sentinel 0xFFFFFFFF and
positions past the filter skipped). On a CUDA tensor one call of the
library computes it in one streaming sweep: the filter read once, the new
one written once. The result is exact for positions in any order, with
duplicates and sentinels anywhere; only the time depends on the order.
Each 64 KiB tile of the filter applies the index range from its first to
its last position: sorted positions give disjoint ranges, each read once,
while unsorted ones give every tile a range across the whole batch. The
overflow is always 0 (Hopper has no window to overflow); ``pos_for_base``
is accepted and ignored. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, scatter_or

KERNEL = _build.CudaKernel("btl_scatter_or_sorted_delta", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p])


def _scratch(nwords: int, device) -> torch.Tensor:
    """The kernel's scratch: the range words of every tile, as
    ``btl_scatter_or_sorted_delta_scratch`` sizes them."""
    fn = _build.library().btl_scatter_or_sorted_delta_scratch
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_longlong]
    return torch.empty(fn(nwords), dtype=torch.int32, device=device)


def scatter_or_sorted_plain(words: torch.Tensor, pos_sorted: torch.Tensor,
                            pos_for_base: torch.Tensor | None = None):
    del pos_for_base
    delta = scatter_or.scatter_or_plain(torch.zeros_like(words), pos_sorted)
    return torch.bitwise_or(words, delta), 0


def scatter_or_sorted(words: torch.Tensor, pos_sorted: torch.Tensor,
                      pos_for_base: torch.Tensor | None = None):
    del pos_for_base
    if _build.on_cpu(words, pos_sorted):
        return scatter_or_sorted_plain(words, pos_sorted)
    scatter_or._check(words, pos_sorted)
    pos = pos_sorted.reshape(-1).contiguous()
    if pos.numel() >= 1 << 31:
        raise ValueError("the delta form takes fewer than 2**31 positions")
    if pos.numel() == 0:
        return words.clone(), 0
    if pos.data_ptr() % 16:     # the kernel reads 16-byte vectors
        pos = pos.clone()
    out = torch.empty_like(words)
    ranges = _scratch(words.numel(), words.device)
    KERNEL.launch(words.device, _build.ptr(pos), pos.numel(),
                  _build.ptr(words), _build.ptr(out), words.numel(),
                  _build.ptr(ranges))
    return out, 0
