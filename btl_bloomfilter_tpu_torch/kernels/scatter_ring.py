"""Bloom insert of sorted bit positions into a delta: the CUDA kernel
``csrc/scatter_or_sorted.cu`` run on a zeros array, and its plain PyTorch
version.

``scatter_or_sorted(words, pos_sorted, pos_for_base=None)`` is the port of
the JAX package's ``kernels/scatter_ring.py:scatter_or_sorted``: the kernel
sets the bits of the positions (int32 holding uint32 bits, sorted, the
sentinel 0xFFFFFFFF and positions past the filter skipped) in a zeros
delta, then a plain ``torch.bitwise_or`` returns ``(words | delta,
overflow)`` as a new tensor and leaves ``words`` untouched, as the JAX
function's OR outside its Pallas kernel does. The overflow is always 0
(Hopper has no window to overflow); ``pos_for_base`` is accepted and
ignored. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build, scatter_or

KERNEL = _build.CudaKernel("btl_scatter_or_sorted", scatter_or.ARGS)


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
    delta = torch.zeros_like(words)
    scatter_or.launch(KERNEL, delta, pos_sorted)
    return torch.bitwise_or(words, delta), 0
