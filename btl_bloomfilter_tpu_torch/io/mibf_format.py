"""MIBF two-file persistence (main file + .sdsl sidecar), byte for byte the
JAX package's ``io/mibf_format.py`` (MIBloomFilter::store/load,
MIBloomFilter.hpp:149-305, 722-742):

  main file:  packed FileHeader {char magic[8]="MIBLOOMF"; uint32 hlen;
              uint64 size (data length); uint32 nhash; uint32 kmer;
              uint32 version=1}   (#pragma pack(1), MIBloomFilter.hpp:107)
              then each spaced-seed string (kmer bytes each),
              then the raw little-endian data array (size * sizeof(T);
              at width 8 the uint64 stream);
  <path>.sdsl: the interleaved bit vector (``io/sdsl.py``).
"""

from __future__ import annotations

import struct

import numpy as np

from ..models import mibf as mibf_mod
from . import sdsl as sdsl_io

MAGIC = b"MIBLOOMF"
VERSION = 1
_HEADER_FMT = "<8sIQIII"  # magic, hlen, size, nhash, kmer, version
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_NP_LE = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<u8"}


def store_mibf(m: mibf_mod.MIBloomFilter, path: str) -> None:
    """Write ``path`` and ``path + ".sdsl"``."""
    hlen = _HEADER_SIZE + m.kmer_size * len(m.sseeds)
    header = struct.pack(_HEADER_FMT, MAGIC, hlen, m.d_size, m.hash_num,
                         m.kmer_size, VERSION)
    with open(path, "wb") as f:
        f.write(header)
        for s in m.sseeds:
            if len(s) != m.kmer_size:
                raise ValueError("spaced seed length != kmer size")
            f.write(s.encode("ascii"))
        f.write(mibf_mod.ids_numpy(m).astype(_NP_LE[m.data_width]).tobytes())
    with open(path + ".sdsl", "wb") as f:
        sdsl_io.write_bit_vector_il(
            f, m.bv_words.cpu().numpy().view(np.uint32), m.size)


def load_mibf(path: str, data_width: int = 2,
              device="cuda") -> mibf_mod.MIBloomFilter:
    """Read ``path`` and its ``.sdsl`` sidecar into a filter on ``device``;
    a bit vector whose popcount is not the header's size raises."""
    mibf_mod.check_width(data_width)
    with open(path, "rb") as f:
        raw = f.read()
    magic, hlen, d_size, nhash, kmer, version = struct.unpack_from(
        _HEADER_FMT, raw, 0)
    if magic != MAGIC:
        raise ValueError("Bloom Filter type does not match")
    if version != VERSION:
        raise ValueError(
            f"Multi Index Bloom Filter version does not match: {version} "
            f"expected: {VERSION}")
    off = _HEADER_SIZE
    sseeds = []
    nseeds = (hlen - _HEADER_SIZE) // kmer if kmer else 0
    for _ in range(nseeds):
        sseeds.append(raw[off: off + kmer].decode("ascii"))
        off += kmer
    if hlen != _HEADER_SIZE + kmer * len(sseeds):
        raise ValueError("header length mismatch (likely version mismatch)")
    body = raw[off:]
    if len(body) != d_size * data_width:
        raise ValueError(
            f"{path} does not match size given by its header: {len(body)}"
            f" vs {d_size * data_width} bytes")
    data = np.frombuffer(body, dtype=_NP_LE[data_width], count=d_size)
    if data_width == 8:
        data = mibf_mod.u64_planes(data)
    with open(path + ".sdsl", "rb") as f:
        bits_u32, size_bits = sdsl_io.deserialize_bit_vector_il(f.read())
    return mibf_mod.from_numpy(bits_u32, data, size=size_bits,
                               hash_num=nhash, kmer_size=kmer,
                               data_width=data_width, sseeds=sseeds,
                               device=device)
