"""Fused ntHash of every window of a read batch: the CUDA kernel
``csrc/nthash_scan.cu`` and its plain PyTorch version.

Two modes of one kernel, with the reference's plane-major layouts
(``btl_bloomfilter_tpu/kernels/nthash_scan.py``):

  * ``hash_frames_planes``: hashes int64 [h, B, W] (uint64 bits);
  * ``positions_planes``:   hash % size with a sentinel (-1) in every slot
    of an invalid window. Below 2**32 bits the narrow form: int32 [h, B,
    W] holding uint32 bits, the sentinel 0xFFFFFFFF. From 2**32 bits (at
    2**32 exactly 0xFFFFFFFF is a real position) up to ``MAX_SIZE`` the
    wide form: int64 [h, B, W], the sentinel -1. The wide form launches
    the kernel's 64-bit instantiation and counts as ``WIDE_KERNEL``.

Both also return strand and valid bool [B, W], W = L - k + 1. A CPU tensor
takes the plain version (``ops/nthash.py``); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import nthash, nthash_tables as T, u64
from ..utils import trace
from . import _build

ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
# one entry point; the wide positions mode counts on its own
KERNEL = _build.CudaKernel("btl_nthash_scan", ARGS)
WIDE_KERNEL = _build.CudaKernel("btl_nthash_scan", ARGS)

# positions_mode of the entry point
HASHES, POSITIONS, WIDE_POSITIONS = 0, 1, 2

# Filter sizes from WIDE_SIZE bits take the wide positions form. Sizes stop
# at MAX_SIZE: a word index p >> 5 then fits 31 bits.
WIDE_SIZE = 1 << 32
MAX_SIZE = 1 << 36

# windows a block of the kernel hashes (TILE in csrc/nthash_scan.cu)
TILE = 2048


def run_length(k: int) -> int:
    """Windows each thread of the kernel rolls, 16 or 32. A run's first
    window costs k steps, so a longer k takes longer runs; on the H100 16
    is faster at k=31 and 32 at k=129 (PERF.md)."""
    return 16 if k < 64 else 32


def check_codes(codes: torch.Tensor, k: int, h: int) -> None:
    """Raise unless codes is a [B, L] batch with L >= k, k >= 1, h >= 1."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(codes.shape)}")
    if k < 1 or h < 1:
        raise ValueError(f"need k >= 1 and h >= 1, got k={k} h={h}")
    if codes.shape[1] < k:
        raise ValueError(f"sequence length {codes.shape[1]} < k={k}")


def check_size(size: int) -> None:
    if not 1 <= size <= MAX_SIZE:
        raise ValueError(f"filter size {size} outside [1, 2**36]: a larger "
                         "filter's word indices pass 2**31")


@functools.lru_cache(maxsize=64)
def barrett(size: int):
    """(magic, shift) for v % size in the kernel; magic 0 means a power of
    two (a mask). magic = floor(2**(63+p) / size), p = size.bit_length()."""
    if size & (size - 1) == 0:
        return 0, 0
    p = size.bit_length()
    return (1 << (63 + p)) // size, p - 1


@functools.lru_cache(maxsize=64)
def roll_tables(k: int):
    """The kernel's roll terms for k, by (out, in) base-code pair at index
    out * 5 + in, as 50 uint64 (a ctypes array): 25 forward terms
    srol^k(seed(out)) ^ seed(in), then 25 reverse terms
    sror(rcseed(out)) ^ srol^(k-1)(rcseed(in)). N's seed is 0."""
    seeds, rc = u64.from_numpy(T.SEEDS), u64.from_numpy(T.RC_SEEDS)
    f = nthash.srol_pow(seeds, k % 33, k % 31)[:, None] ^ seeds[None, :]
    r = (nthash.srol_pow(rc, 32, 30)[:, None]        # sror = srol^-1
         ^ nthash.srol_pow(rc, (k - 1) % 33, (k - 1) % 31)[None, :])
    terms = [int(v) for t in (f, r) for v in u64.to_numpy(t).reshape(-1)]
    return (ctypes.c_uint64 * 50)(*terms)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def hash_frames_planes_plain(codes: torch.Tensor, k: int, h: int):
    check_codes(codes, k, h)
    f = nthash.hash_frames(codes, k, h)
    return f.hashes.movedim(-1, 0).contiguous(), f.strand, f.valid


def positions_planes_plain(codes: torch.Tensor, k: int, h: int, size: int):
    check_codes(codes, k, h)
    check_size(size)
    f = nthash.hash_frames(codes, k, h)
    pos = torch.where(f.valid[..., None], u64.mod_const(f.hashes, size), -1)
    if size < WIDE_SIZE:
        pos = u64.to_u32_bits(pos)
    return pos.movedim(-1, 0).contiguous(), f.strand, f.valid


# ---------------------------------------------------------------------------
# dispatching wrappers
# ---------------------------------------------------------------------------

def as_codes(codes: torch.Tensor) -> torch.Tensor:
    """codes as the kernels read them: contiguous uint8, any code past N
    clamped to N."""
    if codes.dtype != torch.uint8:
        codes = codes.clamp(0, T.CODE_N).to(torch.uint8)
    return codes.contiguous()


def _launch(codes: torch.Tensor, k: int, h: int, size):
    codes = as_codes(codes)
    B, L = codes.shape
    W = L - k + 1
    if B * -(-W // TILE) >= (1 << 31):
        raise ValueError("batch too large for one launch")
    dev = codes.device
    if size is None:
        mode, kernel, dtype = HASHES, KERNEL, torch.int64
    elif size < WIDE_SIZE:
        mode, kernel, dtype = POSITIONS, KERNEL, torch.int32
    else:
        mode, kernel, dtype = WIDE_POSITIONS, WIDE_KERNEL, torch.int64
    out = torch.empty((h, B, W), dtype=dtype, device=dev)
    # strand and valid share one allocation (and not the planes', which a
    # caller holding only valid would keep alive)
    flags = torch.empty((2, B, W), dtype=torch.bool, device=dev)
    strand, valid = flags[0], flags[1]
    if B == 0:
        return out, strand, valid
    magic, shift = barrett(size) if mode else (0, 0)
    kernel.launch(dev, codes.data_ptr(), B, L, k, h, mode,
                  size or 0, magic, shift, run_length(k),
                  ctypes.addressof(roll_tables(k)), out.data_ptr(),
                  strand.data_ptr(), valid.data_ptr())
    return out, strand, valid


def hash_frames_planes(codes: torch.Tensor, k: int, h: int):
    """(hashes int64 [h, B, W], strand bool [B, W], valid bool [B, W])."""
    check_codes(codes, k, h)
    if _build.on_cpu(codes):
        return hash_frames_planes_plain(codes, k, h)
    return _launch(codes, k, h, None)


def positions_planes(codes: torch.Tensor, k: int, h: int, size: int):
    """(pos [h, B, W], strand bool [B, W], valid bool [B, W]): positions
    are hash % size, or the sentinel in every slot of a window that holds
    an N; int32 with 0xFFFFFFFF (-1) below 2**32 bits, int64 with -1 from
    2**32 to 2**36 bits. In a ``btl.hash`` span; counts B * W under
    ``windows`` and h * B * W under ``positions``."""
    check_codes(codes, k, h)
    check_size(size)
    windows = codes.shape[0] * (codes.shape[1] - k + 1)
    trace.count("windows", windows)
    trace.count("positions", h * windows)
    with trace.span("btl.hash"):
        if _build.on_cpu(codes):
            return positions_planes_plain(codes, k, h, size)
        return _launch(codes, k, h, size)
