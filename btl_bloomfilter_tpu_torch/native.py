"""Native FASTA -> N-padded code batches and ASCII -> code encoding, over
the port's own copy of the C++ parser, ``csrc/fastaio.cpp``.

The source has no Python dependency: the port compiles it with g++ into its
own build directory (``btl_bloomfilter_tpu_torch/build``) and binds it with
ctypes. The library's name carries a digest of the source, the flags and the
compiler's identity, so a library built by another compiler or for another
machine is never loaded. The build runs at first use, not at import; a
failing build raises, and nothing falls back to another reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "csrc", "fastaio.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def compiler_identity() -> str:
    """``g++``'s version and target machine, e.g. ``g++ 12.2.0
    x86_64-linux-gnu``; raises if g++ cannot be run."""
    parts = ["g++"]
    for flag in ("-dumpfullversion", "-dumpmachine"):
        run = subprocess.run(["g++", flag], check=True, capture_output=True,
                             text=True)
        parts.append(run.stdout.strip())
    return " ".join(parts)


def library_path() -> str:
    """Where the parser built from ``SRC`` by this compiler lives:
    ``_fastaio_<digest>.so``, the digest over the source's bytes, the flags
    and ``compiler_identity()``."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(b"\0" + " ".join(CXX_FLAGS).encode())
    h.update(b"\0" + compiler_identity().encode())
    return os.path.join(BUILD_DIR, f"_fastaio_{h.hexdigest()[:16]}.so")


def _build() -> str:
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.fasta_open.restype = ctypes.c_void_p
            lib.fasta_open.argtypes = [ctypes.c_char_p]
            lib.fasta_close.restype = None
            lib.fasta_close.argtypes = [ctypes.c_void_p]
            lib.fasta_next_batch.restype = ctypes.c_int64
            lib.fasta_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.encode_ascii.restype = None
            lib.encode_ascii.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            _lib = lib
        return _lib


def encode_ascii(seq: str | bytes) -> np.ndarray:
    """uint8 base codes of an in-memory sequence, by the parser's table
    (the same as ``ops.nthash_tables.CODE_FROM_ASCII``); a ``str`` is
    encoded as ASCII first. A host function: the result is a numpy array."""
    lib = _load()
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    out = np.empty(len(seq), dtype=np.uint8)
    lib.encode_ascii(seq, len(seq),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


class FastaReader:
    """Streaming FASTA -> uint8 [batch, pad] code batches. Reads longer
    than ``pad`` split into chunks overlapping by k-1 bases; rows past the
    last read of the final batch are all N."""

    def __init__(self, path: str, batch: int, pad: int, k: int):
        self._lib = _load()
        self._h = self._lib.fasta_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.batch, self.pad, self.k = batch, pad, k

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if not self._h:
            raise StopIteration
        out = np.empty((self.batch, self.pad), dtype=np.uint8)
        n = self._lib.fasta_next_batch(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.batch, self.pad, self.k)
        if n < 0:
            raise ValueError("bad batch parameters")
        if n == 0:
            self.close()
            raise StopIteration
        return out

    def close(self) -> None:
        if self._h:
            self._lib.fasta_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
