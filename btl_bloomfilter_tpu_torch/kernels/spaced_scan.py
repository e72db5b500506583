"""Spaced-seed ntHash of every window of a read batch: the CUDA kernel
``csrc/spaced_scan.cu`` and its plain PyTorch version.

``spaced_frames_planes(codes, seed_strings, m2)`` takes uint8 codes [B, L]
and returns (hashes int64 [h, B, W] holding uint64 bits, strand bool [h,
B, W], valid bool [B, W]), h = m * m2 planes in the stHashIterator's
seed-major order, W = L - k + 1 with k the seeds' length: the planes of
``ops/seeds.spaced_hash_frames`` (hashes[..., W, h] with its trailing axis
moved to the front), as ``nthash_scan.hash_frames_planes`` lays out the
ntHash frames. Seeds of unequal length and reads shorter than k raise
``ValueError``. A CPU tensor takes the plain version
(``spaced_frames_planes_plain``); a CUDA tensor launches the kernel or
raises.

The kernel rolls each window's unmasked hashes as the ntHash kernel does
(``nthash_scan.roll_tables``, ``nthash_scan.run_length``), then XORs out
each seed's masked terms from ``masked_tables``, the rows of
``offset_tables`` at the masked offsets ``seed_info`` lists.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ..ops import nthash, nthash_tables as T, seeds, u64
from . import _build, nthash_scan

KERNEL = _build.CudaKernel("btl_spaced_scan", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p])

# windows a block of the kernel hashes (TILE in csrc/spaced_scan.cu)
TILE = 1024


def _check(codes: torch.Tensor, seed_strings: Sequence[str], m2: int) -> int:
    """The seeds' length k, after the checks of every form."""
    if codes.dim() != 2:
        raise ValueError(f"codes must be [B, L], got shape {tuple(codes.shape)}")
    if not seed_strings:
        raise ValueError("need at least one spaced seed")
    k = seeds.seed_length(seed_strings)
    if k < 1 or m2 < 1:
        raise ValueError(f"need k >= 1 and m2 >= 1, got k={k} m2={m2}")
    if codes.shape[1] < k:
        raise ValueError(f"sequence length {codes.shape[1]} < k={k}")
    return k


@functools.lru_cache(maxsize=64)
def offset_tables(k: int) -> torch.Tensor:
    """A window's terms by (offset i, base code c) at index i * 5 + c, as
    10 k int64 (uint64 bits): k * 5 forward terms srol^(k-1-i)(seed(c)),
    then k * 5 reverse terms srol^i(rcseed(c)). N's seed is 0."""
    i = torch.arange(k)[:, None]
    f = nthash.srol_pow(u64.from_numpy(T.SEEDS)[None, :], (k - 1 - i) % 33,
                        (k - 1 - i) % 31)
    r = nthash.srol_pow(u64.from_numpy(T.RC_SEEDS)[None, :], i % 33, i % 31)
    return torch.cat([f.reshape(-1), r.reshape(-1)])


@functools.lru_cache(maxsize=64)
def seed_info(seed_strings: Tuple[str, ...]) -> torch.Tensor:
    """int32 [m + 1 + Z]: each seed's first index into the masked offsets
    (and the end of the last), then the masked offsets of all seeds."""
    zeros = seeds.parse_seed_strings(seed_strings)
    starts = [0]
    for z in zeros:
        starts.append(starts[-1] + len(z))
    return torch.tensor(starts + [i for z in zeros for i in z],
                        dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def masked_tables(seed_strings: Tuple[str, ...]) -> torch.Tensor:
    """int64 [Z * 10]: for each masked offset of ``seed_info``, in its
    order, the 5 forward terms of ``offset_tables`` by base code, then the
    5 reverse terms (80 B an offset)."""
    k = seeds.seed_length(seed_strings)
    tab = offset_tables(k)
    tf, tr = tab[:5 * k].view(k, 5), tab[5 * k:].view(k, 5)
    z = [i for zs in seeds.parse_seed_strings(seed_strings) for i in zs]
    return torch.cat([tf[z], tr[z]], 1).reshape(-1)


@functools.lru_cache(maxsize=64)
def _on_device(seed_strings: Tuple[str, ...], device: torch.device):
    """The masked rows and the seed info on ``device``, copied once a seed
    set."""
    return (masked_tables(seed_strings).to(device),
            seed_info(seed_strings).to(device))


def spaced_frames_planes_plain(codes: torch.Tensor,
                               seed_strings: Sequence[str], m2: int):
    _check(codes, seed_strings, m2)
    f = seeds.spaced_hash_frames(codes, seed_strings, m2)
    return (f.hashes.movedim(-1, 0).contiguous(),
            f.strand.movedim(-1, 0).contiguous(), f.valid)


def spaced_frames_planes(codes: torch.Tensor, seed_strings: Sequence[str],
                         m2: int):
    """(hashes int64 [h, B, W], strand bool [h, B, W], valid bool [B, W])."""
    k = _check(codes, seed_strings, m2)
    if _build.on_cpu(codes):
        return spaced_frames_planes_plain(codes, seed_strings, m2)
    if codes.dtype != torch.uint8:
        codes = codes.clamp(0, T.CODE_N).to(torch.uint8)
    codes = codes.contiguous()
    B, L = codes.shape
    W = L - k + 1
    if B * -(-W // TILE) >= (1 << 31):
        raise ValueError("batch too large for one launch")
    h = len(seed_strings) * m2
    dev = codes.device
    hashes = torch.empty((h, B, W), dtype=torch.int64, device=dev)
    strand = torch.empty((h, B, W), dtype=torch.bool, device=dev)
    valid = torch.empty((B, W), dtype=torch.bool, device=dev)
    if B:
        masked, info = _on_device(tuple(seed_strings), dev)
        KERNEL.launch(dev, codes.data_ptr(), B, L, k, len(seed_strings), m2,
                      nthash_scan.run_length(k),
                      ctypes.addressof(nthash_scan.roll_tables(k)),
                      masked.data_ptr(), info.data_ptr(),
                      masked.numel() // 10, hashes.data_ptr(),
                      strand.data_ptr(), valid.data_ptr())
    return hashes, strand, valid
