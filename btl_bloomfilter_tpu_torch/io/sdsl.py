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
    out = []
    queue = [(0, nblocks)]
    while queue and len(out) < cap:
        lb, rb = queue.pop(0)
        if lb < rb:
            mid = lb + (rb - lb) // 2
            out.append(block_ranks[mid])
            queue.append((lb, mid))
            queue.append((mid + 1, rb))
    return np.asarray(out, dtype="<u8")


def _words64_from_bits(bits_u32: np.ndarray, size_bits: int) -> np.ndarray:
    """uint32 word array -> uint64 little-endian word array."""
    n64 = (size_bits + 63) // 64
    u32 = np.zeros(2 * n64, dtype="<u4")
    u32[: bits_u32.shape[0]] = bits_u32
    return u32.view("<u8")


def _bits_u32_from_words64(words64: np.ndarray, size_bits: int) -> np.ndarray:
    n32 = (size_bits + 31) // 32
    u32 = words64.astype("<u8").view("<u4")
    out = np.zeros(n32, dtype=np.uint32)
    out[:] = u32[:n32]
    return out


def serialize_bit_vector_il(bits_u32: np.ndarray, size_bits: int) -> bytes:
    """Serialize a plain bit vector (uint32 words) as bit_vector_il<512>."""
    data64 = _words64_from_bits(np.asarray(bits_u32, np.uint32), size_bits)
    n64 = data64.shape[0]
    nblocks = (n64 + _WORDS_PER_BLOCK - 1) // _WORDS_PER_BLOCK

    popc = np.zeros(n64, dtype=np.uint64)
    v = data64.copy()
    # per-word popcount
    for shift, mask in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                        (4, 0x0F0F0F0F0F0F0F0F)):
        v = (v & np.uint64(mask)) + ((v >> np.uint64(shift)) & np.uint64(mask))
    popc = (v * np.uint64(0x0101010101010101)) >> np.uint64(56)

    interleaved = np.zeros(nblocks * (_WORDS_PER_BLOCK + 1), dtype="<u8")
    cum = np.uint64(0)
    for b in range(nblocks):
        base = b * (_WORDS_PER_BLOCK + 1)
        interleaved[base] = cum
        chunk = data64[b * _WORDS_PER_BLOCK:(b + 1) * _WORDS_PER_BLOCK]
        interleaved[base + 1: base + 1 + chunk.shape[0]] = chunk
        cum = cum + popc[b * _WORDS_PER_BLOCK:(b + 1) * _WORDS_PER_BLOCK].sum()

    samples = _rank_samples(
        interleaved.reshape(nblocks, _WORDS_PER_BLOCK + 1)[:, 0])

    out = bytearray()
    out += struct.pack("<Q", size_bits)                      # m_size
    out += struct.pack("<Q", 64 * interleaved.shape[0])      # m_data bit-size
    out += interleaved.tobytes()
    out += struct.pack("<Q", 64 * samples.shape[0])          # samples bitsize
    out += samples.tobytes()
    return bytes(out)


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
