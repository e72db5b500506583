"""The port's native FASTA parser (``btl_bloomfilter_tpu_torch/native.py``
over its own copy of the C++ source, ``csrc/fastaio.cpp``) against the JAX
package's ``native``: ASCII encoding, batches, a missing file, and the
library's build key.

Inputs are made with numpy from fixed seeds; every compared output is a
uint8 array, so the tolerance is zero.
"""

import os
import re
import subprocess

import numpy as np
import pytest

from btl_bloomfilter_tpu import native as jax_native
from btl_bloomfilter_tpu.ops import nthash_tables as jax_tables
from btl_bloomfilter_tpu_torch import native
from btl_bloomfilter_tpu_torch.ops import nthash_tables

PORT = os.path.dirname(os.path.abspath(native.__file__))


def test_source_is_the_ports_own_copy():
    assert os.path.commonpath([PORT, native.SRC]) == PORT
    assert os.path.dirname(native.SRC) == os.path.join(PORT, "csrc")


@pytest.mark.parametrize("kind", ["bytes", "str"])
def test_encode_ascii_matches_jax(kind):
    rng = np.random.default_rng(20)
    top = 256 if kind == "bytes" else 128       # a str is encoded as ASCII
    every = np.arange(top, dtype=np.uint8)
    buf = np.concatenate([every, rng.permutation(every),
                          rng.integers(0, top, size=1000, dtype=np.uint8)])
    seq = buf.tobytes()
    if kind == "str":
        seq = seq.decode("ascii")
    got = native.encode_ascii(seq)
    assert got.dtype == np.uint8 and got.shape == (len(buf),)
    np.testing.assert_array_equal(got, jax_native.encode_ascii(seq))
    np.testing.assert_array_equal(got, jax_tables.encode_seq(seq))
    np.testing.assert_array_equal(got, nthash_tables.encode_seq(seq))
    np.testing.assert_array_equal(got, nthash_tables.CODE_FROM_ASCII[buf])
    assert native.encode_ascii(seq[:0]).shape == (0,)


def write_fasta(path, seed):
    """Multi-FASTA of reads in upper and lower case with Ns, wrapped at 60
    bases, one read shorter than k and one longer than the pads."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    with open(path, "w") as f:
        for i, n in enumerate((40, 333, 700, 9, 260, 128, 1)):
            seq = alphabet[rng.integers(0, 9, size=n)].tobytes().decode()
            f.write(f">r{i} description {i}\n")
            for j in range(0, n, 60):
                f.write(seq[j: j + 60] + "\n")


@pytest.mark.parametrize("pad", [64, 333])
def test_fasta_reader_matches_jax(tmp_path, pad):
    path = str(tmp_path / "reads.fa")
    write_fasta(path, 21)
    with native.FastaReader(path, 4, pad, 15) as reader:
        got = list(reader)
    ref = list(jax_native.FastaReader(path, 4, pad, 15))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        assert a.dtype == np.uint8 and a.shape == (4, pad)
        np.testing.assert_array_equal(a, b)


def test_fasta_reader_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.FastaReader(str(tmp_path / "absent.fa"), 4, 64, 5)


def test_build_key_names_the_compiler(monkeypatch):
    real = native.library_path()
    assert re.fullmatch(r"_fastaio_[0-9a-f]{16}\.so", os.path.basename(real))
    assert os.path.dirname(real) == native.BUILD_DIR
    assert native.compiler_identity().startswith("g++ ")
    monkeypatch.setattr(native, "compiler_identity",
                        lambda: "g++ 0.0.0 other-machine-linux-gnu")
    other = native.library_path()
    assert other != real
    assert re.fullmatch(r"_fastaio_[0-9a-f]{16}\.so", os.path.basename(other))


@pytest.mark.parametrize("fault", ["missing source", "failing compiler"])
def test_build_faults_raise(tmp_path, monkeypatch, fault):
    """A missing source or a failing g++ raises out of the reader: no
    library is left behind and nothing reads the file another way."""
    fa = str(tmp_path / "reads.fa")
    write_fasta(fa, 22)
    src = tmp_path / "fastaio.cpp"
    if fault == "failing compiler":
        src.write_text("this is not C++\n")
    build = tmp_path / "build"
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    monkeypatch.setattr(native, "_lib", None)
    expect = (FileNotFoundError if fault == "missing source"
              else subprocess.CalledProcessError)
    with pytest.raises(expect):
        native.FastaReader(fa, 4, 64, 15)
    with pytest.raises(expect):
        native.encode_ascii("ACGT")
    assert native._lib is None
    assert not build.exists() or not os.listdir(build)
