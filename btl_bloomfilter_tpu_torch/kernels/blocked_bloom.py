"""Blocked Bloom filter insert and query of canonical hashes: the CUDA
kernel ``csrc/blocked_bloom.cu`` and its plain PyTorch version.

A blocked filter keeps every k-mer's h bits in one 512-bit block: rows
int32 [nblocks, 16] (uint32 bits, the block's bit b in word b >> 5, bit
b & 31). From a k-mer's canonical hash c (int64 holding the uint64 bits),
the block is ``c mod nblocks`` and its h in-block bits are the low 9 bits
of the ntHash multi-hash slots 1..h (``block_and_bits``), as the JAX
package's ``models/blocked.py`` derives them.

  * ``insert(rows, canon, k, h, valid=None)`` sets the h bits of every
    valid k-mer (canon any shape, ``valid`` bool of its shape or None),
    in place, and returns rows;
  * ``contains(rows, canon, k, h, valid=None)`` returns hit bool shaped
    like canon: all h bits set, and False where ``valid`` is False.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import nthash, nthash_tables as T, u64
from . import _build, nthash_scan, scatter_or

BLOCK_BITS = 512
WORDS_PER_BLOCK = BLOCK_BITS // 32

ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong]
INSERT_KERNEL = _build.CudaKernel("btl_blocked_insert", ARGS)
CONTAINS_KERNEL = _build.CudaKernel("btl_blocked_contains",
                                    ARGS + [ctypes.c_void_p])


def _check(rows: torch.Tensor, canon: torch.Tensor, h: int, valid) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 \
            or rows.shape[1] != WORDS_PER_BLOCK or rows.shape[0] < 1:
        raise TypeError("rows must be torch.int32 [nblocks, 16] (uint32 "
                        "bits), nblocks >= 1")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if canon.dtype != torch.int64:
        raise TypeError("canon must be torch.int64 (uint64 bits)")
    if h < 1:
        raise ValueError(f"need h >= 1, got {h}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != canon.shape):
        raise ValueError("valid must be bool shaped like canon")


def block_and_bits(canon: torch.Tensor, nblocks: int, k: int, h: int):
    """(block int64 [...], bits int64 [..., h]): the block of each
    canonical hash and its h in-block bit offsets."""
    block = u64.mod_const(canon, nblocks)
    bits = nthash.derive_hashes(canon, k, h + 1)[..., 1:] & (BLOCK_BITS - 1)
    return block, bits


def insert_plain(rows: torch.Tensor, canon: torch.Tensor, k: int, h: int,
                 valid=None) -> torch.Tensor:
    """Global bit positions block * 512 + bit (int64, -1 for an invalid
    k-mer), then the index OR of ``scatter_or_plain`` over the rows' words."""
    _check(rows, canon, h, valid)
    block, bits = block_and_bits(canon, rows.shape[0], k, h)
    pos = block[..., None] * BLOCK_BITS + bits
    if valid is not None:
        pos = torch.where(valid[..., None], pos, -1)
    scatter_or.scatter_or_plain(rows.view(-1), pos)
    return rows


def contains_plain(rows: torch.Tensor, canon: torch.Tensor, k: int, h: int,
                   valid=None) -> torch.Tensor:
    """A row gather, then each bit's word picked from the row."""
    _check(rows, canon, h, valid)
    block, bits = block_and_bits(canon, rows.shape[0], k, h)
    got = u64.from_u32_bits(rows[block])                   # [..., 16]
    sel = torch.gather(got, -1, bits >> 5)                 # [..., h]
    hit = (((sel >> (bits & 31)) & 1) == 1).all(dim=-1)
    return hit if valid is None else hit & valid


def _launch(kernel, rows, canon, k, h, valid, *out) -> None:
    canon = canon.contiguous()
    n = canon.numel()
    if not n:
        return
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    nblocks = rows.shape[0]
    magic, shift = nthash_scan.barrett(nblocks)
    km = (k * T.MULTI_SEED) & ((1 << 64) - 1)
    kernel.launch(rows.device, canon.data_ptr(),
                  None if valid is None else valid.contiguous().data_ptr(),
                  n, rows.data_ptr(), nblocks, magic, shift, h, km,
                  *(t.data_ptr() for t in out))


def insert(rows: torch.Tensor, canon: torch.Tensor, k: int, h: int,
           valid=None) -> torch.Tensor:
    _check(rows, canon, h, valid)
    tensors = (rows, canon) + (() if valid is None else (valid,))
    if _build.on_cpu(*tensors):
        return insert_plain(rows, canon, k, h, valid)
    _launch(INSERT_KERNEL, rows, canon, k, h, valid)
    return rows


def contains(rows: torch.Tensor, canon: torch.Tensor, k: int, h: int,
             valid=None) -> torch.Tensor:
    _check(rows, canon, h, valid)
    tensors = (rows, canon) + (() if valid is None else (valid,))
    if _build.on_cpu(*tensors):
        return contains_plain(rows, canon, k, h, valid)
    hit = torch.empty(canon.shape, dtype=torch.bool, device=canon.device)
    _launch(CONTAINS_KERNEL, rows, canon, k, h, valid, hit)
    return hit
