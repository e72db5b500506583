"""The Perl binding on the port: ``swig_torch/`` holds byte-for-byte
copies of ``swig/BloomFilter.pm`` and ``swig/test.pl`` and a worker,
``swig_torch/bridge_server.py``, over the port's ``compat`` facade.

``perl swig_torch/test.pl`` runs the reference's SWIG surface through the
port (on the CPU here, ``BTL_BRIDGE_DEVICE=cpu``); both workers, the JAX
package's and the port's, driven over their JSON protocol with the same
requests, give the same replies (getFPR within 1e-6 relative: the JAX
package computes it in float32) and write the same ``.bf`` bytes; and the
port's worker refuses to start without a card unless asked for the CPU.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_WORKER = os.path.join(ROOT, "swig_torch", "bridge_server.py")
JAX_WORKER = os.path.join(ROOT, "swig", "bridge_server.py")


def test_copies_are_byte_for_byte():
    for name in ("BloomFilter.pm", "test.pl"):
        assert filecmp.cmp(os.path.join(ROOT, "swig", name),
                           os.path.join(ROOT, "swig_torch", name),
                           shallow=False), name


@pytest.mark.skipif(shutil.which("perl") is None, reason="perl not found")
def test_perl_smoke_on_the_port():
    r = subprocess.run(
        ["perl", os.path.join(ROOT, "swig_torch", "test.pl")],
        capture_output=True, timeout=300,
        env={**os.environ, "BTL_BRIDGE_DEVICE": "cpu"})
    out = r.stdout.decode()
    assert r.returncode == 0, out + r.stderr.decode()[-2000:]
    assert "Done!" in out
    assert "FAIL" not in out


class Worker:
    """A bridge worker over its pipes: one JSON request a line, one reply
    a line."""

    def __init__(self, script, env):
        self.proc = subprocess.Popen(
            [sys.executable, script], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, **env})
        self.next = 0

    def call(self, op, *args):
        self.next += 1
        self.proc.stdin.write(json.dumps(
            {"id": self.next, "op": op, "args": list(args)}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        assert line, self.proc.stderr.read()[-2000:]
        reply = json.loads(line)
        assert reply["id"] == self.next
        return reply

    def close(self):
        self.proc.stdin.close()
        assert self.proc.wait(timeout=60) == 0


KMERS = ["ATCGGGTCATCAACCAATAT", "ATCGGGTCATCAACCAATAC",
         "GGCATTACGATTAGCATTAG", "TTTTTTTTTTAAAAAAAAAA"]
PROBES = KMERS + ["ATCGGGTCATCAACCAATTA", "CCCCCGGGGGAAAAATTTTT"]


def session(w, tmp, tag):
    """The same requests to either worker: two filters (one of 20-mers
    put in one at a time, then by insertSeq; one of 5-mers by insertSeq),
    queries, getters, a failing request, store and reload. Returns the
    replies (without their ids) and the written files."""
    out = [w.call("ping")]
    f1 = w.call("new", 1 << 20, 5, 20)["result"]
    for km in KMERS:
        out.append(w.call("insert", f1, km))
    out.append(w.call("insertAndCheck", f1, KMERS[0]))
    out.append(w.call("insertAndCheck", f1, "ACGTACGTACGTACGTACGT"))
    out.append(w.call("insertSeq", f1, "GATTACA" * 9, 5, 20))
    out += [w.call("contains", f1, p) for p in PROBES + ["GATTACA" * 3]]
    f2 = w.call("new", 10000, 4, 5)["result"]
    out.append(w.call("insertSeq", f2, "TAGAATCACCCAAAGA", 4, 5))
    out += [w.call(op, fid) for fid in (f1, f2) for op in (
        "getPop", "getFPR", "getHashNum", "getKmerSize", "getFilterSize",
        "sizeInBytes")]
    bad = w.call("contains", 99, "ACGT")
    assert not bad["ok"]
    paths = [os.path.join(tmp, f"{tag}{i}.bf") for i in (1, 2)]
    out += [w.call("storeFilter", fid, p) for fid, p in zip((f1, f2), paths)]
    f3 = w.call("new", paths[0])["result"]
    out += [w.call("contains", f3, p) for p in PROBES]
    out.append(w.call("free", f1))
    return [{k: v for k, v in r.items() if k != "id"} for r in out], paths


def test_port_worker_matches_the_jax_worker(tmp_path):
    port = Worker(PORT_WORKER, {"BTL_BRIDGE_DEVICE": "cpu"})
    ref = Worker(JAX_WORKER, {"JAX_PLATFORMS": "cpu"})
    try:
        got, got_files = session(port, str(tmp_path), "port")
        want, want_files = session(ref, str(tmp_path), "jax")
    finally:
        port.close()
        ref.close()
    # getFPR is a float: the JAX package computes (pop / size) ** h in
    # float32, the port in double, so it is held to 1e-6 relative; every
    # other reply exactly
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w.get("result"), float):
            assert g["result"] == pytest.approx(w["result"], rel=1e-6)
        else:
            assert g == w
    for a, b in zip(got_files, want_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_port_worker_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "BTL_BRIDGE_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, here or on one
    r = subprocess.run([sys.executable, PORT_WORKER], input="",
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert "BTL_BRIDGE_DEVICE=cpu" in r.stderr
