"""The MIBF's random-order, strand-carrying insert (MIBloomFilter::insert):
the CUDA kernel ``csrc/mibf_random_insert.cu`` and its plain version.

``random_insert(bv_words, cum_ranks, rank_dir, data, hashes, size,
id_value, max_count, strand=None, valid=None)`` walks the frames hashes
int64 [n, h] (uint64 bits) in order and writes the ID array ``data``
(uint8 / int16 / int32 bit patterns for ID widths 1 / 2 / 4) in place; it
returns the frames' success flags, bool [n]. Frame f's slot i sits at rank
rank(hashes[f, i] % size) of the frozen bit vector and takes the value
``id_value`` (cut to the width), with the strand bit where ``strand[f,
i]`` differs from the insert's direction (``max_count`` odd); ``valid``
masks frames (an invalid frame writes nothing and fails). The order, the
seeding and the saturation fallback are the reference's (see the CUDA
source); on a frame where the reference asserts, both forms saturate, as
the JAX package's device form does. A rank past the ID array reads its last
entry and writes nothing.

The kernel reads the ranks through the rank directory ``rank_dir``; the
plain version ``random_insert_plain`` through ``bv_words`` and
``cum_ranks`` (``mibf_rank.rank_lookup_plain``), then walks the frames on
the host in Python, the kernel's phases in the same order. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import u64
from ..utils import stdcpp
from . import _build, mibf_rank

KERNEL = _build.CudaKernel("btl_mibf_random_insert", [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

# slots a frame the kernel takes (RI_MAX_H in the CUDA source)
MAX_H = 4096

_NP_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_NP_STORAGE = {1: np.uint8, 2: np.int16, 4: np.int32}   # numpy of the dtypes


def _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid) -> None:
    if hashes.dtype != torch.int64 or hashes.dim() != 2:
        raise TypeError("hashes must be a 2-D int64 tensor (uint64 bits)")
    n, h = hashes.shape
    if not 1 <= h <= MAX_H:
        raise ValueError(f"need 1 <= h <= {MAX_H} slots a frame, got {h}")
    if data.dtype not in (torch.uint8, torch.int16, torch.int32) \
            or data.dim() != 1:
        raise TypeError("data must be a 1-D uint8, int16 or int32 tensor")
    if n and not data.numel():
        raise ValueError("the ID array is empty")
    if not 1 <= size <= 32 * bv_words.numel() or size > (1 << 32):
        raise ValueError(f"size {size} outside [1, 32 * words] or past "
                         "2**32 bits")
    if max_count < 1:
        raise ValueError(f"max_count must be >= 1, got {max_count}")
    if strand is not None and (strand.dtype != torch.bool
                               or strand.shape != hashes.shape):
        raise ValueError("strand must be bool shaped like hashes")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise ValueError("valid must be bool [n]")
    mibf_rank._check_dir(rank_dir, bv_words.numel())


def random_insert_plain(bv_words, cum_ranks, rank_dir, data, hashes, size,
                        id_value, max_count, strand=None, valid=None):
    _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid)
    n, h = hashes.shape
    width = data.element_size()
    smask = 1 << (8 * width - 1)
    anti, sstrand = smask - 1, 1 << (8 * width - 2)
    idv = id_value & ((1 << (8 * width)) - 1)
    pos = u64.to_u32_bits(u64.mod_const(hashes, size))
    ranks = u64.from_u32_bits(mibf_rank.rank_lookup_plain(
        bv_words, cum_ranks, rank_dir, pos)[0]).tolist()
    hv = u64.to_numpy(hashes).tolist()
    st = [[False] * h] * n if strand is None else strand.tolist()
    ok = [True] * n if valid is None else valid.tolist()
    d = data.cpu().numpy().view(_NP_UNSIGNED[width]).tolist()
    last = len(d) - 1
    strand_dir = bool(max_count % 2)
    success = [False] * n
    for f in range(n):
        if not ok[f]:
            continue
        rk = ranks[f]
        vals = [idv | sstrand if strand is not None and strand_dir ^ s
                else idv for s in st[f]]
        # phase A
        count, order, saturated, done, seed = 0, [], True, False, id_value
        for i in range(h):
            old = d[min(rk[i], last)]
            oldv = old & anti if old > smask else old
            if old <= smask:
                saturated = False
            if oldv == vals[i]:
                count += 1
            else:
                order.append(i)
            if count >= max_count:
                done = True
                break
            seed ^= hv[f][i]
        if done:
            success[f] = True
            continue
        # phase B
        order = stdcpp.shuffle(order, stdcpp.MinstdRand(seed))
        for i in order:
            if done:
                break
            old = d[min(rk[i], last)]
            if old == 0:
                if rk[i] <= last:
                    d[rk[i]] = vals[i]
                count += 1
            if old <= smask:
                saturated = False
            done = count >= max_count
        if count == 0 and not saturated:
            for r in rk:
                if r <= last:
                    d[r] |= smask
        success[f] = count > 0
    arr = np.array(d, dtype=_NP_UNSIGNED[width])
    data.copy_(torch.from_numpy(arr.view(_NP_STORAGE[width])))
    return torch.tensor(success, dtype=torch.bool, device=data.device)


def random_insert(bv_words, cum_ranks, rank_dir, data, hashes, size,
                  id_value, max_count, strand=None, valid=None):
    _check(bv_words, cum_ranks, rank_dir, data, hashes, size, max_count,
           strand, valid)
    tensors = [bv_words, cum_ranks, rank_dir, data, hashes] + [
        t for t in (strand, valid) if t is not None]
    if _build.on_cpu(*tensors):
        return random_insert_plain(bv_words, cum_ranks, rank_dir, data,
                                   hashes, size, id_value, max_count, strand,
                                   valid)
    dev = data.device
    n, h = hashes.shape
    success = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        if not data.is_contiguous():
            raise ValueError("data must be contiguous (it is written in "
                             "place)")
        hashes = hashes.contiguous()
        strand = None if strand is None else strand.contiguous()
        valid = None if valid is None else valid.contiguous()
        rank_dir = rank_dir.contiguous()
        if rank_dir.data_ptr() % 16:
            raise ValueError("rank_dir must be 16-byte aligned")
        ranks = torch.empty(n * h, dtype=torch.int32, device=dev)
        null = ctypes.c_void_p(None)
        KERNEL.launch(
            dev, hashes.data_ptr(), n, h, size, rank_dir.data_ptr(),
            bv_words.numel(), data.data_ptr(), data.element_size(),
            data.numel(), id_value & ((1 << 64) - 1), max_count,
            null if strand is None else _build.ptr(strand),
            null if valid is None else _build.ptr(valid), ranks.data_ptr(),
            success.data_ptr())
    return success
