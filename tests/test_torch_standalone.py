"""The port runs from a tree that holds it alone: a copy of
``btl_bloomfilter_tpu_torch/`` (without its build directory) and
``swig_torch/``, with no JAX package beside them and ``PYTHONPATH`` unset.
There, on the CPU, the port's modules import, the FASTA parser builds from
the port's own source, and ``write_bloom`` / ``test_bloom``, ``build_mibf``
/ ``classify`` and ``perl swig_torch/test.pl`` run.

The ``.bf`` bytes are held against the JAX package's for the same file, the
MIBF files and classification lines against the in-repo port's; every
compared output is bytes or text, so the tolerance is zero.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import native as jax_native
from btl_bloomfilter_tpu.io import bf_format as jax_bf_format
from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu.models import kmer_bloom as jax_kmer_bloom
from btl_bloomfilter_tpu_torch.tools import build_mibf, classify, write_bloom
from test_torch_no_jax import IMPORT_CHECK

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 15
FLAGS = ["--batch", "4", "--pad", "128", "--device", "cpu"]


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    """A directory holding only copies of the port and its Perl bridge."""
    top = tmp_path_factory.mktemp("alone")
    skip = shutil.ignore_patterns("build", "__pycache__", "*.pyc", "*.so")
    for name in ("btl_bloomfilter_tpu_torch", "swig_torch"):
        shutil.copytree(os.path.join(ROOT, name), top / name, ignore=skip)
    assert sorted(os.listdir(top)) == ["btl_bloomfilter_tpu_torch",
                                       "swig_torch"]
    return top


def run(alone, *cmd, env=None, timeout=120):
    environ = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(list(cmd), cwd=alone, capture_output=True,
                         text=True, timeout=timeout,
                         env={**environ, **(env or {})})
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    return res


def port_cli(alone, tool, *args):
    return run(alone, sys.executable, "-m",
               f"btl_bloomfilter_tpu_torch.tools.{tool}", *args)


def test_jax_package_is_absent(alone):
    res = subprocess.run(
        [sys.executable, "-c", "import btl_bloomfilter_tpu"], cwd=alone,
        capture_output=True, text=True, timeout=60,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert "No module named 'btl_bloomfilter_tpu'" in res.stderr


def test_port_imports_alone(alone):
    run(alone, sys.executable, "-c", IMPORT_CHECK)


def write_reads(path, seed):
    """Seeded multi-FASTA: ACGT reads, one with Ns, one in lower case,
    one shorter than k, wrapped at 60 bases."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "w") as f:
        for i, n in enumerate((300, 700, 41, 9, 260, 500)):
            seq = acgt[rng.integers(0, 4, size=n)].copy()
            if i == 1:
                seq[rng.random(n) < 0.03] = ord("N")
            if i == 4:
                seq = seq + np.uint8(32)            # lower case
            s = seq.tobytes().decode()
            f.write(f">read{i} record {i}\n")
            for j in range(0, n, 60):
                f.write(s[j: j + 60] + "\n")


def test_write_and_test_bloom_alone(alone, tmp_path):
    fa, out = str(tmp_path / "reads.fa"), str(tmp_path / "alone.bf")
    write_reads(fa, 30)
    port_cli(alone, "write_bloom", "-f", fa, "-k", str(K), "-o", out,
             *FLAGS)
    assert any(n.startswith("_fastaio_") for n in os.listdir(
        alone / "btl_bloomfilter_tpu_torch" / "build"))

    # the JAX package's bytes for the same file and flags
    size, hash_num = write_bloom.filter_specs(os.path.getsize(fa), 0.0001)
    jbf = jax_bloom.create(size, hash_num, K)
    insert = jax.jit(jax_kmer_bloom.insert_seq)
    for codes in jax_native.FastaReader(fa, 4, 128, K):
        jbf = insert(jbf, codes)
    ref = str(tmp_path / "jax.bf")
    jax_bf_format.store_bloom(jbf, ref)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()

    res = port_cli(alone, "test_bloom", "-f", fa, "-b", out, *FLAGS)
    found, total = [int(w) for w in res.stderr.split() if w.isdigit()]
    assert found == total > 0


def write_mibf_inputs(refs_fa, reads_fa, seed):
    """Seeded references and reads drawn from them (some mutated, one
    random, one shorter than k)."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [acgt[rng.integers(0, 4, size=n)].tobytes().decode()
            for n in (400, 650, 300, 520)]
    reads = []
    for i in range(10):
        r = refs[i % len(refs)]
        start = int(rng.integers(0, len(r) - 120))
        read = bytearray(r[start: start + 120].encode())
        if i % 3 == 0:
            read[int(rng.integers(0, 120))] = ord("A")
        reads.append(read.decode())
    reads.append(acgt[rng.integers(0, 4, size=120)].tobytes().decode())
    reads.append("ACGTACGTAC")
    for path, name, seqs in ((refs_fa, "ref", refs), (reads_fa, "q", reads)):
        with open(path, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">{name}{i} sample {i}\n")
                for j in range(0, len(s), 60):
                    f.write(s[j: j + 60] + "\n")


def test_build_mibf_and_classify_alone(alone, tmp_path):
    refs_fa, reads_fa = str(tmp_path / "refs.fa"), str(tmp_path / "q.fa")
    write_mibf_inputs(refs_fa, reads_fa, 31)
    build = ["-k", "17", "-g", "3", "--device", "cpu"]
    query = ["-m", "2", "--batch", "5", "--device", "cpu"]

    out = str(tmp_path / "alone.mibf")
    port_cli(alone, "build_mibf", "-f", refs_fa, *build, "-o", out)
    got = port_cli(alone, "classify", "-f", reads_fa, "-b", out,
                   *query).stdout.splitlines()

    ref = str(tmp_path / "repo.mibf")
    with contextlib.redirect_stdout(io.StringIO()):
        build_mibf.main(["-f", refs_fa, *build, "-o", ref])
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        classify.main(["-f", reads_fa, "-b", ref, *query])
    assert got == lines.getvalue().splitlines()
    assert len(got) == 12 and sum("unclassified" not in g for g in got) >= 9
    for ext in ("", ".sdsl", ".ids"):
        with open(out + ext, "rb") as f, open(ref + ext, "rb") as g:
            assert f.read() == g.read(), ext


@pytest.mark.skipif(shutil.which("perl") is None, reason="perl not found")
def test_perl_bridge_alone(alone):
    res = run(alone, "perl", "swig_torch/test.pl",
              env={"BTL_BRIDGE_DEVICE": "cpu",
                   "BTL_BRIDGE_PYTHON": sys.executable}, timeout=300)
    assert "Done!" in res.stdout
    assert "FAIL" not in res.stdout
