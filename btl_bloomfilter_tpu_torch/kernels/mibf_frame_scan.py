"""Pass C of the MIBF classification engine: the CUDA kernel
``csrc/mibf_frame_scan.cu`` and its plain PyTorch version.

``frame_scan(c6, consider, min_count, valid, frame_sat, frame_eval, hitsum,
extra_frame_limit)`` walks each read's frames in order with the small
sequential state of the reference's query loop (best counts, second-best
nonSatFrame count, extra-frame early exit, candidate existence, saturated
and evaluated frame counts):

  c6          int32 [R, W, h, 6]  per-slot running counts (passes A and B)
  consider    bool  [R, W, h]     slot may promote its ID
  min_count   int32 [R, W, h]     promotion threshold of the slot's ID
  valid       bool  [R, W]        frame enters the engine
  frame_sat   bool  [R, W]        frame holds a saturated hit
  frame_eval  bool  [R, W]        frame bumps evalCount once
  hitsum      int32 [R, W]        hits of the frame

and returns (ok bool [R, W, h], active bool [R, W], best int32 [R, 6],
sat_count int32 [R], eval_count int32 [R]). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = _build.CudaKernel("btl_mibf_frame_scan", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

_COUNT, _TOTALNONSAT, _NONSATFRAME = 0, 3, 4


def _check(c6, consider, min_count, valid, frame_sat, frame_eval, hitsum):
    if c6.dim() != 4 or c6.shape[-1] != 6 or c6.dtype != torch.int32:
        raise ValueError("c6 must be int32 [R, W, h, 6]")
    slots, frames = c6.shape[:3], c6.shape[:2]
    for name, t, shape, dtype in (
            ("consider", consider, slots, torch.bool),
            ("min_count", min_count, slots, torch.int32),
            ("valid", valid, frames, torch.bool),
            ("frame_sat", frame_sat, frames, torch.bool),
            ("frame_eval", frame_eval, frames, torch.bool),
            ("hitsum", hitsum, frames, torch.int32)):
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")


def compare_std_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """compareStdErr in float32: a and b roughly equal within their square
    roots."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    sa, sb = torch.sqrt(af), torch.sqrt(bf)
    return torch.where(af > bf, (af - sa) <= (bf + sb), (bf - sb) <= (af + sa))


def frame_scan_plain(c6, consider, min_count, valid, frame_sat, frame_eval,
                     hitsum, extra_frame_limit: int):
    _check(c6, consider, min_count, valid, frame_sat, frame_eval, hitsum)
    R, W, h, _ = c6.shape
    dev = c6.device
    best = torch.zeros((R, 6), dtype=torch.int32, device=dev)
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    second, extra, satc, evalc = zero, zero, zero, zero
    stopped = torch.zeros(R, dtype=torch.bool, device=dev)
    has_cand = torch.zeros(R, dtype=torch.bool, device=dev)
    oks, actives = [], []
    for t in range(W):
        active = valid[:, t] & ~stopped
        actives.append(active)
        for i in range(h):
            c = c6[:, t, i]
            ok = consider[:, t, i] & active & (
                (c[:, _COUNT] >= min_count[:, t, i])
                | (has_cand & (c[:, _COUNT] >= best[:, _COUNT])))
            has_cand = has_cand | ok
            oks.append(ok)
            nsf = c[:, _NONSATFRAME]
            second = torch.where(
                ok & ~(nsf > best[:, _NONSATFRAME]) & (nsf > second), nsf,
                second)
            best = torch.where(ok[:, None], torch.maximum(best, c), best)
        satc = satc + (active & frame_sat[:, t]).to(torch.int32)
        evalc = (evalc + (frame_eval[:, t] & ~stopped).to(torch.int32)
                 + torch.where(active, hitsum[:, t], 0))
        reset = compare_std_err(best[:, _TOTALNONSAT], second)
        extra = torch.where(active & reset, 0, extra)
        leading = best[:, _NONSATFRAME] > second
        hit_limit = leading & (extra_frame_limit < extra)
        extra = extra + (active & leading).to(torch.int32)
        stopped = stopped | (active & hit_limit)
    ok_slots = (torch.stack(oks, dim=1).reshape(R, W, h) if oks else
                torch.zeros((R, W, h), dtype=torch.bool, device=dev))
    active_frames = (torch.stack(actives, dim=1) if actives else
                     torch.zeros((R, W), dtype=torch.bool, device=dev))
    return ok_slots, active_frames, best, satc, evalc


def frame_scan(c6, consider, min_count, valid, frame_sat, frame_eval, hitsum,
               extra_frame_limit: int):
    _check(c6, consider, min_count, valid, frame_sat, frame_eval, hitsum)
    inputs = (c6, consider, min_count, valid, frame_sat, frame_eval, hitsum)
    if _build.on_cpu(*inputs):
        return frame_scan_plain(*inputs, extra_frame_limit)
    R, W, h, _ = c6.shape
    if not -(1 << 31) <= extra_frame_limit < (1 << 31):
        raise ValueError("extra_frame_limit must fit in int32")
    if W * h * 6 >= (1 << 31):
        raise ValueError("a read of too many frames for one launch")
    dev = c6.device
    inputs = [t.contiguous() for t in inputs]
    ok = torch.empty((R, W, h), dtype=torch.bool, device=dev)
    active = torch.empty((R, W), dtype=torch.bool, device=dev)
    best = torch.empty((R, 6), dtype=torch.int32, device=dev)
    satc = torch.empty(R, dtype=torch.int32, device=dev)
    evalc = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        KERNEL.launch(dev, *(_build.ptr(t) for t in inputs), R, W, h,
                      extra_frame_limit, _build.ptr(ok), _build.ptr(active),
                      _build.ptr(best), _build.ptr(satc), _build.ptr(evalc))
    return ok, active, best, satc, evalc
