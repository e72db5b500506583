"""Block-local ascending sort of uint32 keys: the CUDA kernel
``csrc/block_sort.cu`` and its plain PyTorch version, at two block sizes.

``sort_blocks(x)`` sorts each consecutive ``BLOCK`` = 2048 keys of ``x``
(int32 [n] holding uint32 bits, n % 2048 == 0) in unsigned order, the port
of the JAX package's ``kernels/vmem_sort.py:sort_blocks``.
``chunk_bitonic(x)`` does the same for ``CHUNK`` = 1024-key chunks, the
port of ``bench/partition_probe.py:chunk_bitonic`` (the partition probe,
``probes/partition_probe.py``, calls it). Both return a new tensor. The
plain version sorts the sign-flipped int32 view of each block with
``torch.sort`` and flips back. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

BLOCK = 2048
CHUNK = 1024
SIGN = -(1 << 31)        # int32 0x80000000: flips unsigned to signed order

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
KERNEL = _build.CudaKernel("btl_block_sort", _ARGS)
CHUNK_KERNEL = _build.CudaKernel("btl_block_sort", _ARGS)


def _check(x: torch.Tensor, block: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError("x must be a 1-D torch.int32 tensor (uint32 bits)")
    if x.numel() % block:
        raise ValueError(f"length {x.numel()} is not a multiple of {block}")


def block_sort_plain(x: torch.Tensor, block: int) -> torch.Tensor:
    _check(x, block)
    flipped = x.reshape(-1, block) ^ SIGN
    return (torch.sort(flipped, dim=-1).values ^ SIGN).reshape(-1)


def block_sort(x: torch.Tensor, block: int,
               kernel: _build.CudaKernel) -> torch.Tensor:
    _check(x, block)
    if _build.on_cpu(x):
        return block_sort_plain(x, block)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        kernel.launch(x.device, _build.ptr(x), _build.ptr(out),
                      x.numel() // block, block)
    return out


def sort_blocks_plain(x: torch.Tensor) -> torch.Tensor:
    return block_sort_plain(x, BLOCK)


def sort_blocks(x: torch.Tensor) -> torch.Tensor:
    return block_sort(x, BLOCK, KERNEL)


def chunk_bitonic_plain(x: torch.Tensor) -> torch.Tensor:
    return block_sort_plain(x, CHUNK)


def chunk_bitonic(x: torch.Tensor) -> torch.Tensor:
    return block_sort(x, CHUNK, CHUNK_KERNEL)
