"""The port's spans and counters (``utils/trace.py``) on its Bloom path.

On the CPU: the null span when no profiler runs, the spans' nesting under
``torch.profiler``, the counters' arithmetic (and the part of them taken
under a profiler), the stage kinds, and the
CLIs' ``--trace FILE``. Marked ``cuda`` (skipped without a card): the
pinned stage and the staging ring's bytes, the route span, that a traced
Bloom call queues no more device work than the untraced one, and a
profiled call's ring spans and counts. This file imports neither jax nor the
JAX package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_trace.py
"""

import json

import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu_torch import native
from btl_bloomfilter_tpu_torch.kernels import nthash_scan, scatter_or
from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
from btl_bloomfilter_tpu_torch.tools import test_bloom, write_bloom
from btl_bloomfilter_tpu_torch.utils import trace

K, H, SIZE = 15, 3, 1 << 20


def random_codes(B, L, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    return codes


def profiled_events(fn, tmp_path, cuda=False):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def btl_spans(events):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"], e["tid"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("btl."))


def children(spans, parent):
    """Names of the spans inside the one span named ``parent``, in time
    order, after checking they share its thread."""
    (a, b, _, tid), = [s for s in spans if s[2] == parent]
    inside = [s for s in spans if a <= s[0] and s[1] <= b and s[2] != parent]
    assert all(s[3] == tid for s in inside)
    return [s[2] for s in inside]


def test_span_without_profiler_is_the_shared_null_context(monkeypatch):
    assert trace.span("btl.x") is trace.span("btl.y") is trace._NULL

    def refuse(name):
        raise AssertionError(f"{name} recorded with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    bf = bloom.create(SIZE, H, K, device="cpu")
    kmer_bloom.insert_seq(bf, random_codes(3, 90))
    kmer_bloom.contains_seq(bf, random_codes(3, 90))


def test_cpu_spans_nest_on_one_thread(tmp_path):
    bf = bloom.create(SIZE, H, K, device="cpu")
    codes = random_codes(4, 100)
    events = profiled_events(lambda: kmer_bloom.insert_seq(bf, codes),
                             tmp_path)
    spans = btl_spans(events)
    assert children(spans, "btl.insert_seq") == [
        "btl.stage.none", "btl.hash", "btl.scatter.plain"]
    events = profiled_events(lambda: kmer_bloom.contains_seq(bf, codes),
                             tmp_path)
    assert children(btl_spans(events), "btl.contains_seq") == [
        "btl.stage.none", "btl.hash", "btl.gather"]


@pytest.mark.parametrize("source", ["numpy", "tensor"])
def test_counters_after_known_batches(source):
    bf = bloom.create(SIZE, H, K, device="cpu")
    batches = [random_codes(4, 100, seed=1), random_codes(7, 40, seed=2)]
    if source == "tensor":
        batches = [torch.from_numpy(b) for b in batches]
    trace.reset_counters()
    for b in batches:
        kmer_bloom.insert_seq(bf, b)
    kmer_bloom.contains_seq(bf, batches[0])
    c = trace.counters()
    windows = 2 * 4 * (100 - K + 1) + 7 * (40 - K + 1)
    assert c["windows"] == windows
    assert c["positions"] == H * windows
    assert c["stage_bytes.none"] == 2 * 4 * 100 + 7 * 40
    assert c["stage_bytes.pageable"] == c["stage_bytes.pinned"] == 0
    assert c["calls.insert_seq"] == 2 and c["calls.contains_seq"] == 1
    assert c["route.plain"] == 2 and c["gathers"] == 1
    assert c["route.direct"] == c["route.tiled"] == c["tiles"] == 0


def test_staging_counters_are_named_and_reset():
    ring_names = ("stage_bytes.ring", "stage.chunks", "stage.slot_waits")
    assert set(ring_names) <= set(trace.NAMES)
    for name in ring_names:
        trace.count(name, 3)
    assert all(trace.counters()[n] == 3 for n in ring_names)
    trace.reset_counters()
    assert not any(trace.counters()[n] for n in ring_names)
    assert not any(trace.profiled_counters()[n] for n in ring_names)


def test_counters_hold_launch_counts_and_reset_clears_both():
    c = trace.counters()
    assert "launches.nthash_scan" in c and "launches.scatter_or_tiled" in c
    trace.count("windows", 5)
    nthash_scan.KERNEL.launches += 2
    assert trace.counters()["launches.nthash_scan"] >= 2
    trace.reset_counters()
    assert not any(trace.counters().values())


def test_profiled_counters_count_only_under_a_profiler():
    bf = bloom.create(SIZE, H, K, device="cpu")
    codes = random_codes(4, 100)
    trace.reset_counters()
    kmer_bloom.insert_seq(bf, codes)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        kmer_bloom.insert_seq(bf, codes)
        kmer_bloom.contains_seq(bf, codes)
    kmer_bloom.contains_seq(bf, codes)
    p, c = trace.profiled_counters(), trace.counters()
    assert p["calls.insert_seq"] == p["calls.contains_seq"] == 1
    assert c["calls.insert_seq"] == c["calls.contains_seq"] == 2
    assert p["windows"] == 2 * 4 * (100 - K + 1) == c["windows"] // 2
    assert p["stage_bytes.none"] == 2 * codes.nbytes
    assert not any(k.startswith("launches.") for k in p)
    trace.reset_counters()
    assert not any(trace.profiled_counters().values())


def test_stage_kind():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    codes = random_codes(2, 40)
    assert trace.stage_kind(codes, cuda) == "pageable"
    assert trace.stage_kind(torch.from_numpy(codes), cuda) == "pageable"
    assert trace.stage_kind(codes.tolist(), cuda) == "pageable"
    assert trace.stage_kind(codes, cpu) == "none"
    assert trace.stage_kind(torch.from_numpy(codes), cpu) == "none"


def write_fasta(path, n, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f">r{i}\n" + "".join(rng.choice(list("ACGTN"), 120,
                    p=[0.24, 0.24, 0.24, 0.24, 0.04])) + "\n")


def test_cli_trace_file(tmp_path, capsys):
    fa, out = str(tmp_path / "reads.fa"), str(tmp_path / "out.bf")
    write_fasta(fa, 9)
    with native.FastaReader(fa, 4, 64, 15) as reader:
        nbatches = len(list(reader))
    assert nbatches > 1
    for main, args, entry in (
            (write_bloom.main, ["-k", "15", "-o", out], "btl.insert_seq"),
            (test_bloom.main, ["-b", out], "btl.contains_seq")):
        path = tmp_path / f"{entry}.json"
        main(["-f", fa, "--batch", "4", "--pad", "64", "--device", "cpu",
              "--trace", str(path)] + args)
        names = [e.get("name") for e in
                 json.loads(path.read_text())["traceEvents"]]
        assert names.count(entry) == nbatches
        line, = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("counters ")]
        counts = json.loads(line.removeprefix("counters "))
        assert counts["calls." + entry.removeprefix("btl.")] == nbatches
    main(["-f", fa, "--batch", "4", "--pad", "64", "--device", "cpu"]
         + args)
    assert "counters " not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def queued_in(events, entry):
    """(device operations, runtime calls) queued inside the one span named
    ``entry``, linked by correlation id."""
    (a, b, _, _), = [s for s in btl_spans(events) if s[2] == entry]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                     "cuda_driver")
               and a <= float(e["ts"]) <= b]
    corr = {e["args"].get("correlation") for e in runtime}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["args"].get("correlation") in corr]
    return device, [e["name"] for e in runtime]


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True])
def test_cuda_stage_kind_and_bytes(dev, pinned):
    bf = bloom.create(SIZE, H, K, device=dev)
    codes = torch.from_numpy(random_codes(8, 200))
    if pinned:
        codes = codes.pin_memory()
    kind = "pinned" if pinned else "pageable"
    assert trace.stage_kind(codes, dev) == kind
    assert trace.stage_kind(codes.to(dev), dev) == "none"
    trace.reset_counters()
    kmer_bloom.insert_seq(bf, codes)
    kmer_bloom.insert_seq(bf, codes.to(dev))
    c = trace.counters()
    # a pageable batch goes through the staging ring
    staged = "pinned" if pinned else "ring"
    assert c[f"stage_bytes.{staged}"] == c["stage_bytes.none"] == 8 * 200
    assert c["stage_bytes.pageable"] == 0
    assert sum(v for n, v in c.items()
               if n.startswith("stage_bytes.")) == 2 * 8 * 200


# (size, h, B, L) of a batch that takes each route: a filter of 2**26
# words takes the tiled route from 2**21 positions (here 4M)
ROUTES = {"direct": (1 << 20, 4, 512, 1024), "tiled": (1 << 31, 4, 1024, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cuda_route_span_and_queued_work(dev, route, tmp_path):
    size, h, B, L = ROUTES[route]
    bf = bloom.create(size, h, 31, device=dev)
    codes = random_codes(B, L)
    npos = h * B * (L - 31 + 1)
    assert scatter_or.route(bf.words.numel(), npos) == route
    kmer_bloom.insert_seq(bf, codes)                 # warm: no allocation
    kmer_bloom.contains_seq(bf, codes)
    torch.cuda.synchronize()
    trace.reset_counters()
    events = profiled_events(lambda: (kmer_bloom.insert_seq(bf, codes),
                                      kmer_bloom.contains_seq(bf, codes)),
                             tmp_path, cuda=True)
    spans = btl_spans(events)
    assert children(spans, "btl.insert_seq") == [
        "btl.stage.ring", "btl.hash", f"btl.scatter.{route}"]
    assert children(spans, "btl.contains_seq") == [
        "btl.stage.ring", "btl.hash", "btl.gather"]
    c = trace.counters()
    assert c[f"route.{route}"] == 1
    want = {"insert_seq": ("nthash_scan", "scatter_or", "tp_"),
            "contains_seq": ("nthash_scan", "gather_words")}
    for entry, kernels in want.items():
        device, runtime = queued_in(events, "btl." + entry)
        names = [e["name"] for e in device if e["cat"] == "kernel"]
        assert all(any(k in n for k in kernels) for n in names), names
        assert sum("nthash_scan" in n for n in names) == 1
        assert sum(kernels[1] in n for n in names) == 1
        # one copy queued; the profiler has been seen to drop its device
        # record now and then, so the direction is held where it is there
        assert sum(n.startswith("cudaMemcpy") for n in runtime) == 1, runtime
        assert all(e["name"].startswith("Memcpy HtoD") for e in device
                   if e["cat"] == "gpu_memcpy")
        memsets = [e for e in device if e["cat"] == "gpu_memset"]
        assert not memsets or (entry == "insert_seq" and route == "tiled")
        assert not any(n.startswith("cudaMalloc") for n in runtime), runtime
        assert sum("Synchronize" in n for n in runtime) <= 1, runtime


@pytest.mark.cuda
def test_cuda_profiled_ring_call(dev, tmp_path):
    bf = bloom.create(SIZE, H, K, device=dev)
    codes = random_codes(65536, 150)           # three chunks
    kmer_bloom.contains_seq(bf, codes)
    torch.cuda.synchronize()
    trace.reset_counters()
    events = profiled_events(lambda: kmer_bloom.contains_seq(bf, codes),
                             tmp_path, cuda=True)
    assert children(btl_spans(events), "btl.contains_seq") == 3 * [
        "btl.stage.ring", "btl.hash", "btl.gather"]
    p = trace.profiled_counters()
    assert p["stage_bytes.ring"] == codes.nbytes
    assert p["stage.chunks"] == 3
    assert p["stage_bytes.pageable"] == 0
    device, runtime = queued_in(events, "btl.contains_seq")
    assert sum(n.startswith("cudaMemcpy") for n in runtime) == 3, runtime
    assert not any(n.startswith("cudaMalloc") for n in runtime), runtime
