"""The counting filter's sequence path as the solid-k-mer deployment runs
it (``counting.insert_seq`` on host batches of reads), held against the
benchmark's plain reference (``portbench/reference/counting.py``) and a
one-frame-at-a-time incrementMin loop.

On the CPU: deep replay chains, counters frozen at 255, in-frame duplicate
positions, with and without the multiset grouping and through the
whole-batch replay; the counters' identities; the ``btl.count.*`` spans
inside ``btl.insert_seq``. Marked ``cuda`` (skipped without a card): a
pageable batch through the staging ring against a CUDA-resident one. This
file imports neither jax nor the JAX package; on the card, from the repo
root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_counting_deployment.py
"""

import json

import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu_torch.models import counting
from btl_bloomfilter_tpu_torch.utils import staging, trace
from portbench.reference import counting as ref_counting

torch.set_num_threads(1)


def random_reads(B, L, seed, n_share=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < n_share] = 4
    return codes


def repeated_reads(B, L, seed):
    """B / 2 copies each of two reads: over two batches their k-mers count
    up to 255 and freeze."""
    two = random_reads(2, L, seed, n_share=0)
    return two[np.arange(B) % 2]


# name: (size in bytes, h, k, batches); every case replays chains at least
# three frames deep
CASES = {
    "deep chains": (256, 4, 15, [random_reads(16, 40, s) for s in (1, 2)]),
    "frozen": (1024, 3, 31, [repeated_reads(300, 40, 3)] * 2),
    "in-frame duplicates": (8, 4, 11, [random_reads(6, 30, s)
                                       for s in (5, 6)]),
}


def one_at_a_time(frames, size):
    """incrementMin frame after frame, as the C++ loop runs it: each
    distinct counter equal to the frame's minimum goes up by one, nothing
    once the minimum is 255."""
    c = np.zeros(size, dtype=np.int64)
    for f in frames.tolist():
        low = min(c[p] for p in f)
        if low < 255:
            for p in set(f):
                if c[p] == low:
                    c[p] += 1
    return c


def reference(size, h, k, batches):
    ref = ref_counting.Counters(size, h, k, "cpu")
    frames, rounds = [], []
    for b in batches:
        f = ref.frames(torch.from_numpy(b))
        rounds.append(ref.apply(f))
        frames.append(f)
    return ref, torch.cat(frames), rounds


def port(size, h, k, batches, **kw):
    cbf = counting.create(size, h, k, 3, 1, device="cpu")
    for b in batches:
        counting.insert_seq(cbf, b, **kw)
    return cbf


@pytest.fixture(scope="module")
def references():
    return {name: reference(*case) for name, case in CASES.items()}


@pytest.mark.parametrize("max_entangled", [None, 1])
@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_reference_equals_loop(references, case, group,
                                           max_entangled):
    size, h, k, batches = CASES[case]
    ref, frames, rounds = references[case]
    want = one_at_a_time(frames, size)
    assert np.array_equal(ref.counts.numpy().astype(np.int64), want)
    trace.reset_counters()
    cbf = port(size, h, k, batches, group_duplicates=group,
               max_entangled=max_entangled)
    assert np.array_equal(counting.to_numpy(cbf).astype(np.int64), want)
    assert ref.words_differing(cbf.counters) == 0
    assert max(rounds) >= 3
    if case == "frozen":
        assert want.max() == 255
    if case == "in-frame duplicates":
        assert any(len(set(f)) < h for f in frames.tolist())
    c = trace.counters()
    assert (c["count.whole_batch_replays"] > 0) == (max_entangled == 1)
    assert c["calls.insert_seq"] == len(batches)


@pytest.mark.parametrize("max_entangled", [None, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_counter_identities(monkeypatch, case, max_entangled):
    """Under a profiler: frames = closed + replayed, the closed frames
    those the closed-form step applies; steps = the conservative steps
    run. Outside one, the counts that read the device stay at zero."""
    size, h, k, batches = CASES[case]
    calls, closed = [], []
    step_for = counting._step_for

    def counted(cbf):
        step = step_for(cbf)

        def run(p, c, live=None):
            calls.append(p.shape[1])
            if live is not None:             # the closed form
                closed.append(int(c[live].sum()))
            return step(p, c, live)
        return run

    monkeypatch.setattr(counting, "_step_for", counted)
    trace.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        port(size, h, k, batches, max_entangled=max_entangled)
    c = trace.profiled_counters()
    valid = sum(int(ref_counting.Counters(size, h, k, "cpu").frames(
        torch.from_numpy(b)).shape[0]) for b in batches)
    assert c["count.frames"] == valid
    assert c["count.closed_frames"] == sum(closed)
    assert c["count.frames"] == (c["count.closed_frames"]
                                 + c["count.replayed_frames"])
    assert c["count.steps"] == len(calls) > len(batches)
    assert trace.counters()["count.frames"] == valid
    if max_entangled == 1:
        assert c["count.whole_batch_replays"] == len(batches)
        assert c["count.closed_frames"] == 0 and not closed
    trace.reset_counters()
    port(size, h, k, batches, max_entangled=max_entangled)
    c = trace.counters()
    assert c["count.steps"] == len(calls) // 2
    assert c["count.closed_frames"] == 0
    assert c["count.frames"] == (valid if max_entangled == 1 else 0)


def test_queries_equal_reference(references):
    size, h, k, batches = CASES["frozen"]
    ref = references["frozen"][0]
    cbf = port(size, h, k, batches)
    query = np.concatenate([batches[0][:5], random_reads(5, 40, 9)])
    trace.reset_counters()
    mc, valid = counting.min_count_seq(cbf, query)
    hit, valid2 = counting.contains_seq(cbf, query)
    want, want_valid = ref.min_counts(torch.from_numpy(query))
    assert torch.equal(valid, want_valid) and torch.equal(valid2, valid)
    assert torch.equal(torch.where(valid, mc, 0), torch.where(valid, want, 0))
    assert torch.equal(hit, valid & (want >= 3))
    assert trace.counters()["calls.contains_seq"] == 2


class CpuRing:
    """The staging ring's contract on the CPU: chunks in plan order, each a
    copy, overwritten once ``fn`` has returned."""

    def __init__(self, chunk_bytes):
        self.chunk_bytes, self.chunks = chunk_bytes, []

    def map(self, fn, flat, split):
        pieces = staging.plan(flat.shape[0],
                              flat.shape[1] * flat.element_size(),
                              self.chunk_bytes)
        for group in ([p] for p in pieces) if split else [pieces]:
            a, b = group[0][0], group[-1][1]
            self.chunks.append((a, b))
            slot = flat[a:b].clone()
            out = fn(slot)
            slot.fill_(3)
            yield out


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_staging_equals_one_copy(monkeypatch, references, case):
    """Through a ring that hands the rows over a few at a time, the
    counters and answers equal one copy's: the chunks' positions are
    joined in row order before the one decomposition."""
    size, h, k, batches = CASES[case]
    ref = references[case][0]
    rows, L = batches[0].shape
    ring = CpuRing(3 * L)
    monkeypatch.setattr(staging, "takes", lambda flat, device: True)
    monkeypatch.setattr(staging, "ring", lambda device: ring)
    cbf = port(size, h, k, batches)
    assert ref.words_differing(cbf.counters) == 0
    assert ring.chunks[:len(staging.plan(rows, L, 3 * L))] == staging.plan(
        rows, L, 3 * L)
    mc, valid = counting.min_count_seq(cbf, batches[1])
    want, want_valid = ref.min_counts(torch.from_numpy(batches[1]))
    assert torch.equal(valid, want_valid)
    assert torch.equal(torch.where(valid, mc, 0), torch.where(valid, want, 0))


def profiled_spans(fn, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"], e["tid"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("btl."))


def children(spans, parent):
    (a, b, _, tid), = [s for s in spans if s[2] == parent]
    inside = [s for s in spans if a <= s[0] and s[1] <= b and s[2] != parent]
    assert all(s[3] == tid for s in inside)
    return [s[2] for s in inside]


@pytest.mark.parametrize("max_entangled", [None, 1])
def test_count_spans_inside_the_entry(tmp_path, max_entangled):
    size, h, k, batches = CASES["deep chains"]
    cbf = counting.create(size, h, k, 3, 1, device="cpu")
    spans = profiled_spans(lambda: counting.insert_seq(
        cbf, batches[0], max_entangled=max_entangled), tmp_path)
    tail = (["btl.count.replay"] if max_entangled == 1
            else ["btl.count.closed", "btl.count.replay"])
    assert children(spans, "btl.insert_seq") == [
        "btl.stage.none", "btl.hash", "btl.count.decompose",
        "btl.count.group"] + tail
    assert children(spans, "btl.count.decompose") == ["btl.count.group"]
    spans = profiled_spans(lambda: counting.min_count_seq(cbf, batches[0]),
                           tmp_path)
    assert children(spans, "btl.contains_seq") == ["btl.stage.none",
                                                   "btl.hash"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 65536])
def test_cuda_ring_counters_equal_resident(dev, B):
    """Reads staged from a pageable array the caller reuses (a batch that
    fits a slot, and one staged whole past it) give the counters that the
    same reads handed over on the card give, at the deployment's 2**30
    one-byte counters."""
    batches = [random_reads(B, 150, 20 + i, n_share=0.001)
               for i in range(3)]
    batches.append(batches[0].copy())            # repeated reads
    want = counting.create(1 << 30, 4, 31, 3, 1, device=dev)
    for b in batches:
        counting.insert_seq(want, torch.from_numpy(b).to(dev))
    cbf = counting.create(1 << 30, 4, 31, 3, 1, device=dev)
    buf = np.empty_like(batches[0])
    trace.reset_counters()
    for b in batches:
        buf[:] = b
        counting.insert_seq(cbf, buf)
        buf[:] = 4
    torch.cuda.synchronize()
    assert torch.equal(cbf.counters, want.counters)
    c = trace.counters()
    assert c["stage_bytes.pageable"] == 0
    assert c["stage_bytes.ring"] == sum(b.nbytes for b in batches)
    assert c["launches.conservative_step"] == c["count.steps"]
    assert all(t.numel() == staging.CHUNK_BYTES
               for t in staging.ring(dev).dev)
    mc, valid = counting.min_count_seq(cbf, batches[1])
    want_mc, want_valid = counting.min_count_seq(
        want, torch.from_numpy(batches[1]).to(dev))
    assert torch.equal(mc, want_mc) and torch.equal(valid, want_valid)
