"""``spans.summarize`` on a synthetic trace (innermost attribution by
thread, idle time inside staging, uncovered device time, entry counts) and
on the port's CLI trace, the ``stage_pageable_pct`` readers on the port's
profiled counts, and the harness's traced path on the CPU."""

import json
import sys
import types

import numpy as np
import pytest
import torch

import tiny
from portbench import run, spans, trace

PAGEABLE = {"build": "stage_pageable_pct.build",
            "query": "stage_pageable_pct.query"}


def ann(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def op(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def synthetic():
    """Two calls in a 1000 us window, each insert_seq > stage, hash,
    scatter; a span on another thread over the first call's hash; one
    operation queued in a call but outside every btl. span, one outside
    every call."""
    return [
        ann(trace.WINDOW, 0, 1000),
        ann(trace.CALL, 100, 200), ann(trace.CALL, 500, 200),
        ann("btl.insert_seq", 110, 180),
        ann("btl.stage.pageable", 115, 35), launch(3, 120),
        ann("btl.hash", 160, 40), launch(1, 170),
        ann("btl.scatter.direct", 210, 70), launch(2, 220),
        launch(8, 295),                                 # uncovered
        ann("btl.insert_seq", 510, 180),
        ann("btl.stage.pageable", 515, 45), launch(7, 520),
        ann("btl.hash", 570, 30), launch(4, 575),
        ann("btl.scatter.tiled", 610, 70), launch(5, 615), launch(6, 620),
        ann("btl.gather", 150, 100, tid=2),             # another thread
        launch(9, 400),                                 # outside the calls
        op(3, 118, 12, cat="gpu_memcpy", name="Memcpy HtoD (Pageable)"),
        op(1, 140, 40), op(2, 230, 50), op(8, 296, 3),
        op(7, 522, 20, cat="gpu_memcpy", name="Memcpy HtoD (Pageable)"),
        op(4, 600, 20), op(5, 625, 10), op(6, 640, 30), op(9, 800, 5),
    ]


def test_summarize_synthetic_trace():
    s = spans.summarize(synthetic())
    assert s.calls == 2 and s.entries == {"btl.insert_seq": 2}
    assert s.spans["btl.hash"] == 2 and s.spans["btl.scatter.tiled"] == 1
    assert s.kernel_s == pytest.approx({
        "btl.hash": 60e-6, "btl.scatter.direct": 50e-6,
        "btl.scatter.tiled": 40e-6})
    assert s.copy_s == pytest.approx({"btl.stage.pageable": 32e-6})
    # every operation queued in a call, of which op 8 in no btl. span
    assert s.call_device_s == pytest.approx((12 + 40 + 50 + 3 + 20 + 20
                                             + 10 + 30) * 1e-6)
    assert s.uncovered_s == pytest.approx(3e-6)
    # staging 115-150 and 515-560; kernels run 140-180, none in the second
    assert s.idle_stage_s == pytest.approx((25 + 45) * 1e-6)
    # kernel-idle time by the innermost span of the host's thread (1)
    assert s.idle_s == pytest.approx({
        "btl.stage.pageable": 70e-6, "btl.hash": 50e-6,
        "btl.scatter.direct": 20e-6, "btl.scatter.tiled": 20e-6,
        "btl.insert_seq": 50e-6, "outside": 632e-6})
    assert s.window_s == pytest.approx(1e-3)
    assert spans.per_entry_ms(s, "btl.insert_seq", "btl.hash") == (
        pytest.approx(0.03))
    assert spans.per_entry_ms(s, "btl.insert_seq", "btl.scatter") == (
        pytest.approx(0.045))
    assert spans.per_entry_ms(s, "btl.contains_seq", "btl.gather") is None


def test_summarize_without_a_window():
    """A trace with no harness window (the CLIs' ``--trace FILE``) spans
    the port's entries; one with neither summarizes to None."""
    events = [e for e in synthetic()
              if e["name"] not in (trace.WINDOW, trace.CALL)]
    s = spans.summarize(events)
    assert s.entries == {"btl.insert_seq": 2} and s.calls == 0
    assert s.window_s == pytest.approx(580e-6)
    assert s.kernel_s == pytest.approx({
        "btl.hash": 60e-6, "btl.scatter.direct": 50e-6,
        "btl.scatter.tiled": 40e-6})
    assert spans.summarize([e for e in events
                            if not e["name"].startswith("btl.")]) is None


def port_trace():
    from btl_bloomfilter_tpu_torch.utils import trace as port
    return port


def test_stage_pageable_reads_the_profiled_counts(monkeypatch):
    port = port_trace()
    monkeypatch.setattr(port, "PROFILED", dict(
        port.PROFILED, **{"stage_bytes.pageable": 300,
                          "stage_bytes.pinned": 100, "stage_bytes.none": 0}))
    ctx = types.SimpleNamespace(kind="build", trace=object())
    assert run.read_metric(PAGEABLE["build"], ctx) == pytest.approx(75.0)
    assert run.read_metric(PAGEABLE["query"], ctx) is None
    ctx.trace = None                        # a CPU run: no device trace
    assert run.read_metric(PAGEABLE["build"], ctx) is None
    monkeypatch.setattr(port, "PROFILED", dict.fromkeys(port.NAMES, 0))
    ctx.trace = object()                    # nothing staged under the profiler
    assert run.read_metric(PAGEABLE["build"], ctx) is None


@pytest.mark.parametrize("older", ["no module", "no profiled counts"])
def test_stage_pageable_silent_without_port_counts(older, monkeypatch):
    """A port that keeps no profiled counts (an older tree): the readers
    report nothing, and nothing raises."""
    if older == "no module":
        from btl_bloomfilter_tpu_torch import utils
        monkeypatch.delattr(utils, "trace")
        monkeypatch.setitem(sys.modules,
                            "btl_bloomfilter_tpu_torch.utils.trace", None)
    else:
        monkeypatch.delattr(port_trace(), "profiled_counters")
    assert spans.profiled_counts() is None
    for kind, name in PAGEABLE.items():
        ctx = types.SimpleNamespace(kind=kind, trace=object())
        assert run.read_metric(name, ctx) is None


def test_main_reads_a_cli_trace(tmp_path, capsys):
    from btl_bloomfilter_tpu_torch import native
    from btl_bloomfilter_tpu_torch.tools import write_bloom
    rng = np.random.default_rng(5)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n" + "".join(rng.choice(list("ACGT"), 90))
                          + "\n" for i in range(10)))
    with native.FastaReader(str(fa), 4, 64, 15) as reader:
        nbatches = len(list(reader))
    path = tmp_path / "trace.json"
    write_bloom.main(["-f", str(fa), "-k", "15", "-o",
                      str(tmp_path / "out.bf"), "--batch", "4", "--pad",
                      "64", "--device", "cpu", "--trace", str(path)])
    capsys.readouterr()
    assert spans.main([str(path)]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["entries"] == {"btl.insert_seq": nbatches} and nbatches > 1
    assert s["spans"]["btl.hash"] == s["spans"]["btl.scatter.plain"] == (
        nbatches)
    path.write_text(json.dumps({"traceEvents": []}))
    assert spans.main([str(path)]) == 1


@pytest.mark.parametrize("kind", ["build", "query"])
def test_traced_cpu_run_profiles_the_window_alone(kind):
    """The harness's traced path on the CPU: the port's profiled counts
    hold the window's calls alone (not set-up's, not the check's), and no
    device metric is reported."""
    port = port_trace()
    bench = run.load_benchmark()
    cell = {"build": "grch38.build", "query": "grch38.query.host90"}[kind]
    e2e, layer = run.cell_metrics(bench, cell)
    assert PAGEABLE[kind] in {m["name"] for m in layer}
    mix = tiny.BUILD if kind == "build" else tiny.QUERY
    port.reset_counters()
    res = run.run(tiny.CONFIG, mix, e2e, layer, seed=2**31 + 11,
                  seconds=0.2, traced=True, device="cpu",
                  mixes=tiny.MIXES.get)
    assert res["correct"] and res["metrics"] == {}
    entry = "calls." + ("insert_seq" if kind == "build" else "contains_seq")
    counts = spans.profiled_counts()
    assert counts[entry] == res["attempted"] > 0
    assert port.counters()[entry] > res["attempted"]
    assert counts["stage_bytes.none"] > 0
    assert spans.pageable_pct(counts) == 0.0


@pytest.mark.cuda
def test_pinned_source_reads_no_pageable_share(cuda_device):
    from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
    port = port_trace()
    bf = bloom.create(1 << 24, 4, 31, device=cuda_device)
    codes = torch.from_numpy(np.full((64, 256), 2, np.uint8)).pin_memory()
    ctx = types.SimpleNamespace(kind="build", trace=object())
    for source, want in ((codes, 0.0), (codes.numpy(), 100.0)):
        port.reset_counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            kmer_bloom.insert_seq(bf, source)
        kmer_bloom.insert_seq(bf, codes.numpy())    # not profiled
        assert run.read_metric(PAGEABLE["build"], ctx) == want
