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
    like canon: all h bits set, and False where ``valid`` is False;
  * ``insert_seq(rows, codes, k, h)`` inserts every k-mer window with no N
    of a read batch codes [B, L] (A=0 C=1 G=2 T=3, any code >= 4 an N), in
    place, and returns rows: ntHash and the insert in one kernel, no hash
    in global memory; its plain version is ntHash's hash mode then
    ``insert_plain``. It counts as ``SEQ_KERNEL``.

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
SEQ_KERNEL = _build.CudaKernel(
    "btl_blocked_insert_seq",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong])


def _check_rows(rows: torch.Tensor, h: int) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 \
            or rows.shape[1] != WORDS_PER_BLOCK or rows.shape[0] < 1:
        raise TypeError("rows must be torch.int32 [nblocks, 16] (uint32 "
                        "bits), nblocks >= 1")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if h < 1:
        raise ValueError(f"need h >= 1, got {h}")


def _check(rows: torch.Tensor, canon: torch.Tensor, h: int, valid) -> None:
    _check_rows(rows, h)
    if canon.dtype != torch.int64:
        raise TypeError("canon must be torch.int64 (uint64 bits)")
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


def insert_seq_plain(rows: torch.Tensor, codes: torch.Tensor, k: int,
                     h: int) -> torch.Tensor:
    """ntHash's hash mode (plain) for the canonical hashes and valid flags,
    then ``insert_plain``."""
    planes, _strand, valid = nthash_scan.hash_frames_planes_plain(codes, k,
                                                                  1)
    return insert_plain(rows, planes[0], k, h, valid)


def _constants(rows: torch.Tensor, k: int):
    """(nblocks, magic, shift, km) of the kernels' block and bits."""
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")
    nblocks = rows.shape[0]
    magic, shift = nthash_scan.barrett(nblocks)
    return nblocks, magic, shift, (k * T.MULTI_SEED) & ((1 << 64) - 1)


def _launch(kernel, rows, canon, k, h, valid, *out) -> None:
    canon = canon.contiguous()
    n = canon.numel()
    if not n:
        return
    nblocks, magic, shift, km = _constants(rows, k)
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


def insert_seq(rows: torch.Tensor, codes: torch.Tensor, k: int,
               h: int) -> torch.Tensor:
    nthash_scan.check_codes(codes, k, h)
    _check_rows(rows, h)
    if _build.on_cpu(rows, codes):
        return insert_seq_plain(rows, codes, k, h)
    codes = nthash_scan.as_codes(codes)
    B, L = codes.shape
    if B * -(-(L - k + 1) // nthash_scan.TILE) >= (1 << 31):
        raise ValueError("batch too large for one launch")
    if B:
        nblocks, magic, shift, km = _constants(rows, k)
        SEQ_KERNEL.launch(rows.device, codes.data_ptr(), B, L, k,
                          nthash_scan.run_length(k),
                          ctypes.addressof(nthash_scan.roll_tables(k)),
                          rows.data_ptr(), nblocks, magic, shift, h, km)
    return rows
