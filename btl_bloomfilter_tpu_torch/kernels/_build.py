"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` compiles with its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ctypes. The build runs at first use, into
``btl_bloomfilter_tpu_torch/build/``, under a name that carries a digest of
the sources and flags, so an edited source is never served by a stale
library. Nothing here runs at import time: the CPU tests import every
module on machines that have no ``nvcc``.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``CudaKernel.launch`` raises on a nonzero code and
counts the launches that went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("nthash_scan.cu", "scatter_or.cu", "gather_words.cu",
           "gather_counters.cu", "scatter_add.cu", "mibf_rank.cu",
           "mibf_frame_scan.cu", "scatter_or_sorted.cu", "block_sort.cu",
           "window_scatter.cu", "dma_sweep.cu", "conservative_step.cu",
           "tile_partition.cu", "spaced_scan.cu", "mibf_random_insert.cu",
           "blocked_bloom.cu", "errors.cu")
HEADERS = ("common.cuh", "nthash_roll.cuh", "tile_partition.cuh",
           "tile_stream.cuh")

# uint32 position of an invalid window (BTL_SENTINEL in csrc/common.cuh); it
# is -1 in the int32 position tensors.
SENTINEL = 0xFFFFFFFF

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "",
             "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libbloom_kernels_{_digest()}.so")


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise if any fails. Returns their
    joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{o}")
    return "".join(outs)


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. With ``verbose`` nvcc also prints -Xptxas -v
    (registers, shared memory, spills per kernel)."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s + ".o") for s in SOURCES]
        log = _run_all([
            [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", o, os.path.join(CSRC, s)]
            for s, o in zip(SOURCES, objs)])
        lib = os.path.join(tmpdir, "lib.so")
        log += _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print(log, end="")
        os.replace(lib, out)   # atomic: concurrent builds race harmlessly
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.btl_cuda_error_string.restype = ctypes.c_char_p
            lib.btl_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """The dispatch rule: True when every tensor lies on the CPU (take the
    plain version), False when every one lies on CUDA (launch the kernel).
    Anything else raises; there is no fallback."""
    if len(tensors) == 1 and tensors[0].is_cuda:
        return False
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return False
    raise ValueError(f"unsupported devices {sorted(kinds)}: "
                     "expected all on the CPU or all on one CUDA device")


class CudaKernel:
    """One C entry point of the kernel library, with a launch counter.
    ``also``: kernels the entry point launches as well (each launch counts
    for them too)."""

    def __init__(self, symbol: str, argtypes, also=()):
        self.symbol = symbol
        self.also = tuple(also)
        # every entry ends with (int device, void* stream)
        self.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p]
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on the current stream of ``device``; raise on a launch
        error, count the launch otherwise. Arguments are ints (pointers as
        ``Tensor.data_ptr()``), converted by the entry's argtypes."""
        fn = self._fn or self._function()
        index = device.index
        if index == torch.cuda.current_device():
            err = fn(*args, index, _raw_stream(index))
        else:
            with torch.cuda.device(device):
                err = fn(*args, index, _raw_stream(index))
        if err != 0:
            msg = library().btl_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
        for k in self.also:
            k.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as a cudaStream_t,
    without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(index)
