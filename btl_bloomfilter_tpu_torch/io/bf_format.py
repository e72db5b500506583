"""Byte-exact ``.bf`` codec for the classic Bloom filter (BTLBloomFilter_v1)
and the counting Bloom filter (BTLCountingBloomFilter_v1).

A copy of ``btl_bloomfilter_tpu/io/bf_format.py``: the port may not import
the JAX package. The file is a text header ending in
``[HeaderEnd]`` followed by the filter bytes. The header's field order is
the reference's (cpptoml's hash-map iteration order, captured from golden
files) and doubles are written as C++ ``showpoint`` + ``setprecision(17)``,
which python's ``%#.17g`` matches. The body is the words as little-endian
uint32, cut to ``size // 8`` bytes; a counting filter's body is its
little-endian counter array, and its counter width is
``BloomFilterSizeInBytes // BloomFilterSize``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..models import bloom, counting

BLOOM_MAGIC = "BTLBloomFilter_v1"
COUNTING_MAGIC = "BTLCountingBloomFilter_v1"

_BLOOM_FIELD_ORDER = ["nEntry", "dFPR", "Entry", "BloomFilterSizeInBytes",
                      "BloomFilterSize", "HashNum", "KmerSize"]
_COUNTING_FIELD_ORDER = ["BloomFilterSize", "HashNum", "KmerSize",
                         "BloomFilterSizeInBytes", "BitsPerCounter"]


def _fmt_double(x: float) -> str:
    return "%#.17g" % float(x)


def _header_bytes(magic: str, order, values) -> bytes:
    lines = [f"[{magic}]"]
    for key in order:
        v = values[key]
        sval = _fmt_double(v) if isinstance(v, float) else str(int(v))
        lines.append(f"\t{key} = {sval}")
    lines.append("[HeaderEnd]")
    return ("\n".join(lines) + "\n").encode("ascii")


def bloom_header_bytes(*, size: int, size_in_bytes: int, hash_num: int,
                       kmer_size: int, dfpr: float, n_entry: int,
                       t_entry: int) -> bytes:
    return _header_bytes(BLOOM_MAGIC, _BLOOM_FIELD_ORDER, {
        "nEntry": n_entry, "dFPR": float(dfpr), "Entry": t_entry,
        "BloomFilterSizeInBytes": size_in_bytes, "BloomFilterSize": size,
        "HashNum": hash_num, "KmerSize": kmer_size,
    })


def counting_header_bytes(*, size: int, size_in_bytes: int, hash_num: int,
                          kmer_size: int, bits_per_counter: int = 8) -> bytes:
    return _header_bytes(COUNTING_MAGIC, _COUNTING_FIELD_ORDER, {
        "BloomFilterSize": size, "HashNum": hash_num, "KmerSize": kmer_size,
        "BloomFilterSizeInBytes": size_in_bytes,
        "BitsPerCounter": bits_per_counter,
    })


def parse_header(data: bytes,
                 expected_magic: str = BLOOM_MAGIC) -> Tuple[Dict[str, str], int]:
    """Parse the text header; returns (fields, offset of the filter bytes)."""
    end_marker = b"[HeaderEnd]\n"
    idx = data.find(end_marker)
    if idx < 0:
        raise ValueError(".bf file has no [HeaderEnd] marker")
    lines = data[: idx + len(end_marker)].decode("ascii").splitlines()
    if lines[0] != f"[{expected_magic}]":
        raise ValueError(
            f"magic string mismatch: got {lines[0]!r}, "
            f"expected [{expected_magic}] (likely version mismatch)")
    fields: Dict[str, str] = {}
    for line in lines[1:]:
        line = line.strip()
        if not line or line.startswith("["):
            continue
        key, _, val = line.partition("=")
        fields[key.strip()] = val.strip()
    return fields, idx + len(end_marker)


def words_to_bytes(words: np.ndarray, size_in_bytes: int) -> bytes:
    """uint32 words -> the reference's byte layout (LSB-first bits within
    bytes), which is exactly their little-endian serialization (one copy of
    the filter)."""
    return np.asarray(words, dtype="<u4").view(np.uint8)[:size_in_bytes] \
        .tobytes()


def bytes_to_words(buf: bytes) -> np.ndarray:
    pad = (-len(buf)) % 4
    if pad:
        buf = buf + b"\0" * pad
    return np.frombuffer(buf, dtype="<u4").copy()


def store_bloom(bf: bloom.BloomFilter, path: str) -> None:
    """Write a filter byte-identically to the reference's storeFilter."""
    header = bloom_header_bytes(
        size=bf.size, size_in_bytes=bf.size_in_bytes, hash_num=bf.hash_num,
        kmer_size=bf.kmer_size, dfpr=bf.dfpr, n_entry=bf.n_entry,
        t_entry=bf.t_entry)
    body = words_to_bytes(bloom.to_numpy_words(bf), bf.size_in_bytes)
    with open(path, "wb") as f:
        f.write(header)
        f.write(body)


def load_bloom(path: str, device="cuda") -> bloom.BloomFilter:
    """Read a ``.bf`` file into a filter on ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    fields, off = parse_header(data)
    size = int(fields["BloomFilterSize"])
    size_in_bytes = int(fields["BloomFilterSizeInBytes"])
    body = data[off: off + size_in_bytes]
    if len(body) != size_in_bytes:
        raise ValueError("truncated .bf file")
    nwords = (size + 31) // 32
    words = bytes_to_words(body)
    if words.shape[0] < nwords:
        words = np.pad(words, (0, nwords - words.shape[0]))
    return bloom.from_numpy_words(
        words[:nwords], size, int(fields["HashNum"]),
        int(fields["KmerSize"]), dfpr=float(fields.get("dFPR", 0.0)),
        n_entry=int(fields.get("nEntry", 0)),
        t_entry=int(fields.get("Entry", 0)), device=device)


def store_counting(cbf: counting.CountingBloomFilter, path: str) -> None:
    """Write a counting filter byte-identically to the reference's
    CountingBloomFilter::storeFilter."""
    header = counting_header_bytes(
        size=cbf.size, size_in_bytes=cbf.size_in_bytes,
        hash_num=cbf.hash_num, kmer_size=cbf.kmer_size,
        bits_per_counter=cbf.bits_per_counter)
    with open(path, "wb") as f:
        f.write(header)
        f.write(cbf.counter_bytes())


def load_counting(path: str, count_threshold: int,
                  device="cuda") -> counting.CountingBloomFilter:
    """Read a counting ``.bf`` file into a filter on ``device``; the file
    does not hold the threshold, so the caller gives it."""
    with open(path, "rb") as f:
        data = f.read()
    fields, off = parse_header(data, COUNTING_MAGIC)
    size = int(fields["BloomFilterSize"])
    size_in_bytes = int(fields["BloomFilterSizeInBytes"])
    body = data[off: off + size_in_bytes]
    if len(body) != size_in_bytes:
        raise ValueError("truncated .bf file")
    return counting.from_bytes(
        body, size=size, hash_num=int(fields["HashNum"]),
        kmer_size=int(fields["KmerSize"]), count_threshold=count_threshold,
        counter_width=size_in_bytes // size if size else 1,
        bits_per_counter=int(fields.get("BitsPerCounter", 8)), device=device)
