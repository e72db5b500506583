"""The harness at a tiny size on the CPU: sound runs are correct, the
control and every fault a cell can have are not, nothing loads JAX, and the
trace arithmetic and BENCHMARK.json hold together."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import tiny
from conftest import ROOT
from portbench import run, trace
from portbench.control import ControlApi

CELLS = {"build": "grch38.build", "query": "grch38.query.host90"}


def _run(kind, api=None, traced=False, seed=2**31 + 7):
    bench = run.load_benchmark()
    e2e, layer = run.cell_metrics(bench, CELLS[kind])
    mix = tiny.BUILD if kind == "build" else tiny.QUERY
    return run.run(tiny.CONFIG, mix, e2e, layer, seed=seed, seconds=0.2,
                   traced=traced, device="cpu", mixes=tiny.MIXES.get,
                   api=api)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("kind", ["build", "query"])
def test_sound_run_is_correct(kind, traced):
    res = _run(kind, traced=traced)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())
    if not traced:
        want = {"build": {"build_kmers_per_s", "setup_s"},
                "query": {"query_kmers_per_s", "query_batch_ms.p95",
                          "setup_s"}}[kind]
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert res["metrics"] == {}     # no device trace on the CPU


class Faulty:
    """The port's entry points with one fault planted."""

    def __init__(self, fault):
        from btl_bloomfilter_tpu_torch.models import kmer_bloom
        self.kb, self.fault = kmer_bloom, fault

    def insert_seq(self, bf, codes):
        codes = torch.as_tensor(codes)
        if self.fault == "unchanged":
            return bf
        if self.fault == "half":
            return self.kb.insert_seq(bf, codes[:codes.shape[0] // 2])
        self.kb.insert_seq(bf, codes)
        if self.fault == "altered":     # the first word written, cleared
            bf.words[torch.nonzero(bf.words)[0]] = 0
        return bf

    def contains_seq(self, bf, codes):
        codes = torch.as_tensor(codes)
        if self.fault == "half":
            hit, valid = self.kb.contains_seq(bf, codes)
            hit[hit.shape[0] // 2:] = False
            return hit, valid
        hit, valid = self.kb.contains_seq(bf, codes)
        if self.fault == "altered":
            hit[0, 0] = ~hit[0, 0]
        return hit, valid


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", ["build", "query"])
def test_faults_are_not_correct(kind, fault):
    res = _run(kind, api=Faulty(fault))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("kind", ["build", "query"])
def test_control_is_not_correct(kind):
    """The reference with 32-bit hashes in the port's place fails; at full
    width the same stand-in passes, so only the precision fails it."""
    res = _run(kind, api=ControlApi(32))
    assert res["correct"] is False
    assert res["checks"]["filter_words_differing"]["value"] > 1000
    assert _run(kind, api=ControlApi(64))["correct"] is True


def test_no_jax_after_a_rehearsal():
    """In a fresh interpreter: run.py's imports, then a tiny run of each
    kind; no module whose top-level name is a JAX one is loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import tiny\n"
        "from portbench import run\n"
        "b = run.load_benchmark()\n"
        "for cell, mix in (('grch38.build', tiny.BUILD),"
        " ('grch38.query.host90', tiny.QUERY)):\n"
        "    e, l = run.cell_metrics(b, cell)\n"
        "    r = run.run(tiny.CONFIG, mix, e, l, seed=1, seconds=0.1,"
        " traced=False, device='cpu', mixes=tiny.MIXES.get)\n"
        "    assert r['correct']\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        % (ROOT, os.path.dirname(__file__)))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH="")).stdout
    found, tops = out.strip().splitlines()[-2:]
    assert found == "[]"
    tops = set(ast.literal_eval(tops))
    assert "btl_bloomfilter_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "btl_bloomfilter_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    """Every import under portbench/, by whole top-level name (the port's
    name begins with the JAX package's); the reference imports no port."""
    here = os.path.join(ROOT, "portbench")
    seen = 0
    for dirpath, _dirs, files in os.walk(here):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            seen += 1
            assert not tops & {"jax", "jaxlib", "flax",
                               "btl_bloomfilter_tpu"}, path
            if os.sep + "reference" + os.sep in path:
                assert "btl_bloomfilter_tpu_torch" not in tops, path
    assert seen > 20


def test_forbidden_names_compare_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["btl_bloomfilter_tpu_torch_x"] = sys
        assert "btl_bloomfilter_tpu" not in run.forbidden_modules()
        sys.modules["btl_bloomfilter_tpu.models"] = sys
        assert "btl_bloomfilter_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_summary_by_hand():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("user_annotation", trace.CALL, 10, 100),
        _ev("cuda_runtime", "cudaMemcpyAsync", 20, 5, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 5, 2),
        _ev("user_annotation", trace.CALL, 500, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, 3),
        _ev("cuda_runtime", "cudaLaunchKernel", 700, 5, 4),   # harness
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30, 50, 1),
        _ev("kernel", "void a_kernel<int>(int const*)", 100, 200, 2),
        _ev("kernel", "void b_kernel(float)", 520, 100, 3),
        _ev("kernel", "void at::native::reduce_kernel<1>(x)", 710, 40, 4),
        _ev("cpu_op", "aten::copy_", 300, 150),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(390e-6)          # 50 + 200 + 100 + 40
    assert s.kernel_s == pytest.approx(340e-6)
    assert s.call_kernel_s == pytest.approx(300e-6)   # not the harness's
    assert s.call_h2d_s == pytest.approx(50e-6)
    assert s.calls == 2
    assert s.device_ops[0] == ["a_kernel<int>", pytest.approx(200e-6)]
    gaps = dict(s.idle_gaps)
    assert gaps["aten::copy_"] == pytest.approx(220e-6)   # 300-520
    assert sum(gaps.values()) == pytest.approx(1e-3 - 390e-6)
    assert trace.summarize([e for e in events if e["cat"] != "kernel"
                            and e["cat"] != "gpu_memcpy"]) is None


def test_benchmark_json_holds_together():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           name + ".py")), name
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        config = run.load_config(bench, cell["config"])
        assert config["name"] == cell["config"]
        mix = run.load_mix(cell["traffic"])
        assert mix["kind"] in ("build", "query")
        e2e, layer = run.cell_metrics(bench, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in e2e}
        assert configs[cell["config"]]["reduced"] == []
    for c in configs.values():
        from portbench.filters import bloom
        cfg = run.load_config(bench, c["name"])
        assert bloom.specs(cfg) == (cfg["size_bits"], cfg["hash_num"])


@pytest.mark.cuda
def test_cuda_path_is_correct_at_a_small_size(cuda_device):
    """The port's kernels against the reference on the card, both kinds,
    with the faults' stand-in: the control."""
    bench = run.load_benchmark()
    for kind, mix in (("build", tiny.BUILD), ("query", tiny.QUERY)):
        e2e, layer = run.cell_metrics(bench, CELLS[kind])
        for api, want in ((None, True), (ControlApi(32), False)):
            res = run.run(tiny.CONFIG, mix, e2e, layer, seed=3, seconds=0.5,
                          traced=api is None, device=cuda_device,
                          mixes=tiny.MIXES.get, api=api)
            assert res["correct"] is want, (kind, res["checks"])
