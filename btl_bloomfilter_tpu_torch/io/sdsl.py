"""sdsl-style interleaved bit vector serialization (bit_vector_il<512>).

A copy of ``btl_bloomfilter_tpu/io/sdsl.py`` (numpy only): the port may
not import the JAX package, whose ``__init__`` imports jax.

The reference persists its MIBF top-level bit vector via
``sdsl::store_to_file(m_bv, path + ".sdsl")`` (MIBloomFilter.hpp:294-297)
where ``m_bv`` is ``sdsl::bit_vector_il<512>`` (MIBloomFilter.hpp:801).

The repository does not depend on sdsl-lite, so this module implements a
RECONSTRUCTION of that on-disk
format from the sdsl-lite layout:

  uint64 m_size                      bit length of the vector
  int_vector<64> m_data              8-byte bit-size header (64 * #words)
                                     followed by raw little-endian words:
                                     per 512-bit superblock, one cumulative
                                     rank word followed by eight 64-bit
                                     data words (interleaved layout)
  int_vector<64> m_rank_samples      binary-search-tree samples over the
                                     superblock cumulative ranks (sdsl's
                                     select acceleration): a BFS of the
                                     [0, nblocks) midpoints, each sample
                                     the midpoint superblock's cumulative
                                     rank word

Round-trips through this module are byte-stable and rank-consistent, and
``deserialize_bit_vector_il`` validates the samples against the
interleaved rank words (so a file whose tree disagrees with its data is
rejected). Exact byte parity against genuine sdsl-lite output is not
tested (the repository holds no sdsl-lite source or output); the residual
risks are the rank-sample vector's LENGTH convention and any trailing
total-rank word — both documented in docs/PARITY.md.
"""

from __future__ import annotations

import io
import struct

import numpy as np

BLOCKSIZE = 512
_WORDS_PER_BLOCK = BLOCKSIZE // 64


def _rank_samples(block_ranks: np.ndarray) -> np.ndarray:
    """Select-acceleration tree: BFS over [0, nblocks) midpoints storing
    the midpoint superblock's cumulative rank. Depth-limited to the
    complete-tree size 2**ceil(log2(nblocks)) - 1."""
    nblocks = int(block_ranks.shape[0])
    if nblocks <= 1:
        return np.zeros(0, dtype="<u8")
    depth = max(1, (nblocks - 1).bit_length())
    cap = (1 << depth) - 1
    # the BFS a level at a time (a FIFO queue visits the levels in order,
    # each level's intervals in their parents' order), vectorised: one
    # interval a block would take a Python loop of 2**23 steps at 2**32 bits
    lb, rb = np.zeros(1, np.int64), np.full(1, nblocks, np.int64)
    out, total = [], 0
    while lb.size and total < cap:
        keep = lb < rb
        lb, rb = lb[keep], rb[keep]
        mid = lb + (rb - lb) // 2
        out.append(block_ranks[mid])
        total += mid.size
        lb = np.stack([lb, mid + 1], axis=1).reshape(-1)
        rb = np.stack([mid, rb], axis=1).reshape(-1)
    if not out:
        return np.zeros(0, dtype="<u8")
    return np.concatenate(out)[:cap].astype("<u8")


def _bits_u32_from_words64(words64: np.ndarray, size_bits: int) -> np.ndarray:
    n32 = (size_bits + 31) // 32
    u32 = np.ascontiguousarray(words64, dtype="<u8").view("<u4")
    return np.array(u32[:n32], dtype=np.uint32)


# superblocks the writer interleaves at a time (16 MiB of words)
_POP_BLOCKS = 1 << 18


def write_bit_vector_il(f, bits_u32: np.ndarray, size_bits: int) -> None:
    """Write a plain bit vector (uint32 words) as bit_vector_il<512> to the
    binary file ``f``, _POP_BLOCKS superblocks at a time: per superblock
    its cumulative rank word, then its eight data words (zero past the
    vector); then the rank samples. No copy of the whole vector is made."""
    bits_u32 = np.asarray(bits_u32, np.uint32)
    n64 = (size_bits + 63) // 64
    nblocks = (n64 + _WORDS_PER_BLOCK - 1) // _WORDS_PER_BLOCK
    words = bits_u32[: 2 * n64]
    ranks = np.empty(nblocks, dtype=np.uint64)
    total = np.uint64(0)
    f.write(struct.pack("<Q", size_bits))                    # m_size
    f.write(struct.pack("<Q", 64 * (_WORDS_PER_BLOCK + 1) * nblocks))
    for b in range(0, nblocks, _POP_BLOCKS):
        e = min(b + _POP_BLOCKS, nblocks)
        flat = np.zeros(2 * _WORDS_PER_BLOCK * (e - b), dtype="<u4")
        part = words[2 * _WORDS_PER_BLOCK * b: 2 * _WORDS_PER_BLOCK * e]
        flat[: part.shape[0]] = part
        chunk = np.empty((e - b, _WORDS_PER_BLOCK + 1), dtype="<u8")
        chunk[:, 1:] = flat.view("<u8").reshape(e - b, _WORDS_PER_BLOCK)
        sums = _popcount64(chunk[:, 1:]).sum(axis=1)
        chunk[:, 0] = np.cumsum(sums) - sums + total
        total += sums.sum()
        ranks[b:e] = chunk[:, 0]
        f.write(chunk)
    samples = _rank_samples(ranks)
    f.write(struct.pack("<Q", 64 * samples.shape[0]))        # samples bitsize
    f.write(samples)


def serialize_bit_vector_il(bits_u32: np.ndarray, size_bits: int) -> bytes:
    """Serialize a plain bit vector (uint32 words) as bit_vector_il<512>."""
    buf = io.BytesIO()
    write_bit_vector_il(buf, bits_u32, size_bits)
    return buf.getvalue()


def _popcount64(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64, copy=True)
    for shift, mask in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                        (4, 0x0F0F0F0F0F0F0F0F)):
        v = (v & np.uint64(mask)) + ((v >> np.uint64(shift)) & np.uint64(mask))
    return (v * np.uint64(0x0101010101010101)) >> np.uint64(56)


def deserialize_bit_vector_il(buf: bytes, with_info: bool = False):
    """Parse bit_vector_il<512> bytes -> (bits_u32, size_bits)
    (or ``(bits_u32, size_bits, info)`` when ``with_info``).

    Tolerant of both conventions this reconstruction cannot pin down
    without genuine sdsl-lite output (docs/PARITY.md deviations 1):

    * an OPTIONAL trailing total-rank word after the interleaved blocks
      (accepted iff it equals the vector's total rank);
    * the rank-sample vector LENGTH: any prefix/extension of the expected
      BFS tree is accepted as long as the overlap matches and any extra
      entries are zero padding.

    ``info`` records which variant was read
    (``{"trailing_total_rank": bool, "sample_convention": str}``).
    Corrupt/mismatched files are still rejected."""
    size_bits = struct.unpack_from("<Q", buf, 0)[0]
    data_bits = struct.unpack_from("<Q", buf, 8)[0]
    nwords = data_bits // 64
    interleaved = np.frombuffer(buf, dtype="<u8", count=nwords, offset=16)
    # strip the per-superblock rank words; tolerate one trailing
    # total-rank word (sdsl stores the closing cumulative rank in some
    # rank-support layouts)
    nblocks, rem = divmod(nwords, _WORDS_PER_BLOCK + 1)
    trailing = False
    if rem == 1:
        trailing = True
        body = interleaved[:-1]
        total = interleaved[-1]
    elif rem == 0:
        body = interleaved
        total = None
    else:
        raise ValueError(
            f".sdsl interleaved data length {nwords} is not a whole "
            f"number of {_WORDS_PER_BLOCK + 1}-word superblocks "
            "(+ optional trailing total-rank word)")
    il = body.reshape(nblocks, _WORDS_PER_BLOCK + 1)
    if total is not None:
        expect_total = (int(il[-1, 0]) +
                        int(_popcount64(il[-1, 1:]).sum())) if nblocks \
            else 0
        if int(total) != expect_total:
            raise ValueError(
                f".sdsl trailing total-rank word {int(total)} != computed "
                f"total rank {expect_total}")
    off = 16 + nwords * 8
    sample_bits = struct.unpack_from("<Q", buf, off)[0]
    nsamples = sample_bits // 64
    convention = "absent"
    if nsamples:
        samples = np.frombuffer(buf, dtype="<u8", count=nsamples,
                                offset=off + 8)
        expect = _rank_samples(il[:, 0])
        m = min(nsamples, expect.shape[0])
        if not np.array_equal(samples[:m], expect[:m]):
            raise ValueError(
                ".sdsl rank samples disagree with interleaved rank words")
        if nsamples > expect.shape[0]:
            if np.any(samples[expect.shape[0]:] != 0):
                raise ValueError(
                    ".sdsl rank-sample tail beyond the BFS tree is "
                    "non-zero")
            convention = "zero-padded"
        elif nsamples == expect.shape[0] - 1:
            # exactly one fewer entry: a plausible tree-size convention
            # (complete tree minus the closing leaf); anything shorter is
            # indistinguishable from a corrupt/cut-short file -> reject
            convention = "truncated"
        elif nsamples < expect.shape[0]:
            raise ValueError(
                f".sdsl rank-sample vector has {nsamples} entries; "
                f"expected {expect.shape[0]} (or one fewer) — file "
                "truncated or corrupt")
        else:
            convention = "bfs-tree"
    data64 = il[:, 1:].reshape(-1)
    n64 = (size_bits + 63) // 64
    bits = _bits_u32_from_words64(data64[:n64], size_bits)
    if with_info:
        return bits, size_bits, {"trailing_total_rank": trailing,
                                 "sample_convention": convention}
    return bits, size_bits
