"""Counting-filter conservative step: the CUDA kernel
``csrc/conservative_step.cu`` and its plain PyTorch version.

``conservative_step(words, pos, c, shift, counter_max)`` applies one step
of the conservative update to packed counters (counter p is lane
``p & (per - 1)`` of ``words[p >> shift]``, ``per = 1 << shift``) for the
frames pos [h, m] (plane-major; narrow, int32 holding uint32 bits with
the sentinel 0xFFFFFFFF, or wide, int64 with the sentinel -1, for a filter
of exactly 2**32 counters: the kernel's wide instantiation, counted as
``WIDE_KERNEL``), frame f repeated
``c[f]`` times (int64 [m]): every counter of the frame becomes
``max(cur, mn + min(c, counter_max - mn))``, mn the frame's minimum. That
is incrementMin for c = 1 and the closed form of c repeats of a frame, the
freeze at counter_max included.

The frames of one step must be position-disjoint, as the decomposition's
closed-form rows and its replay rounds are. An in-frame duplicate slot
writes once; a sentinel slot reads 0 and writes nothing, and a
frame whose slot 0 is the sentinel writes nothing; a word index past the
array reads the last word and writes nothing. Positions must lie inside the
counters (or be the sentinel) for the kernel to equal the plain version: a
clamped read may race with another frame's write. Updates ``words`` (int32
[nwords]) in place and returns it. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import u64
from . import _build
from .gather_counters import gather_counters_plain
from .scatter_add import scatter_add_plain

ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
        ctypes.c_void_p]
KERNEL = _build.CudaKernel("btl_conservative_step", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_conservative_step_wide", ARGS)

# slots a thread keeps in registers (H_MAX in csrc/conservative_step.cu);
# past it the kernel keeps the lanes in a scratch array
H_MAX = 8


def _check(words: torch.Tensor, pos: torch.Tensor, c: torch.Tensor,
           shift: int, counter_max: int) -> None:
    if words.dtype != torch.int32:
        raise TypeError("words must be torch.int32 (uint32 bits)")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("pos must be torch.int32 (uint32 bits) or int64")
    if words.dim() != 1 or words.numel() == 0 or not words.is_contiguous():
        raise ValueError("words must be a non-empty contiguous 1-D tensor")
    if pos.dim() != 2 or pos.shape[0] < 1:
        raise ValueError("pos must be [h, m] with h >= 1")
    if c.dtype != torch.int64 or c.shape != pos.shape[1:]:
        raise TypeError("c must be torch.int64 shaped [m]")
    if shift not in (0, 1, 2):
        raise ValueError(f"shift must be 0, 1 or 2, got {shift}")
    if not 0 <= counter_max < (1 << (32 >> shift)):
        raise ValueError(f"counter_max {counter_max} does not fit a "
                         f"{32 >> shift}-bit lane")


def earlier_dup_mask(p: torch.Tensor) -> torch.Tensor:
    """True where an earlier slot of the same frame holds the same
    position: p is [h, m] plane-major. A frame updates such a counter once,
    as the reference's compare-and-swap loop does."""
    dup = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for j in range(1, p.shape[0]):
        dup[j] = (p[:j] == p[j]).any(dim=0)
    return dup


def conservative_step_plain(words: torch.Tensor, pos: torch.Tensor,
                            c: torch.Tensor, shift: int,
                            counter_max: int) -> torch.Tensor:
    """Gather the lanes, take the frame's min and target, and add each
    writing slot's delta target - cur: the deltas stay inside their lanes."""
    _check(words, pos, c, shift, counter_max)
    cur = gather_counters_plain(words, pos, shift, "vals")
    mn = cur.amin(dim=0)
    target = mn + torch.minimum(c, counter_max - mn)
    write = (pos[0] != -1) & ~earlier_dup_mask(pos) & (cur < target)
    delta = torch.where(write, target - cur, 0)
    return scatter_add_plain(words, pos, shift, counter_max,
                             inc=u64.to_u32_bits(delta))


def conservative_step(words: torch.Tensor, pos: torch.Tensor,
                      c: torch.Tensor, shift: int,
                      counter_max: int) -> torch.Tensor:
    _check(words, pos, c, shift, counter_max)
    if _build.on_cpu(words, pos, c):
        return conservative_step_plain(words, pos, c, shift, counter_max)
    pos = pos.contiguous()
    c = c.contiguous()
    h, m = pos.shape
    if m:
        scratch = (torch.empty(pos.shape, dtype=torch.int32,
                               device=pos.device) if h > H_MAX else None)
        kernel = WIDE_KERNEL if pos.dtype == torch.int64 else KERNEL
        kernel.launch(words.device, _build.ptr(pos), _build.ptr(c), m, h,
                      _build.ptr(words), words.numel(), shift, counter_max,
                      None if scratch is None else _build.ptr(scratch))
    return words
