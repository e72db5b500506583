"""Copy sweep: the CUDA kernel ``csrc/dma_sweep.cu`` and its plain PyTorch
version, the port of the kernel behind ``bench/partition_probe.py:
dma_sweep`` (the partition probe, ``probes/partition_probe.py``, calls it).

``sweep_copy(src, k, rows)`` returns a new tensor equal to ``src`` (int32
[nsteps * k * rows, 128]), copied as ``nsteps * k`` chunks of ``rows`` rows
(``rows * 512`` bytes), k chunks a grid step. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LANES = 128

KERNEL = _build.CudaKernel("btl_dma_sweep", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong])


def _check(src: torch.Tensor, k: int, rows: int) -> int:
    """Returns the number of grid steps."""
    if src.dtype != torch.int32 or src.dim() != 2 or src.shape[1] != LANES:
        raise TypeError(f"src must be torch.int32 [rows, {LANES}]")
    if k < 1 or rows < 1 or src.shape[0] % (k * rows):
        raise ValueError(f"{src.shape[0]} rows are not whole steps of "
                         f"{k} x {rows} rows")
    return src.shape[0] // (k * rows)


def sweep_copy_plain(src: torch.Tensor, k: int, rows: int) -> torch.Tensor:
    nsteps = _check(src, k, rows)
    return src.reshape(nsteps, k, rows, LANES).clone().reshape(src.shape)


def sweep_copy(src: torch.Tensor, k: int, rows: int) -> torch.Tensor:
    nsteps = _check(src, k, rows)
    if _build.on_cpu(src):
        return sweep_copy_plain(src, k, rows)
    src = src.contiguous()
    if src.data_ptr() % 16:
        raise ValueError("src must be 16-byte aligned")
    dst = torch.empty_like(src)
    if nsteps:
        KERNEL.launch(src.device, _build.ptr(src), _build.ptr(dst), nsteps,
                      k, rows)
    return dst
