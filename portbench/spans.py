"""Reading the port's own spans and counters in a traced window.

The port marks its Bloom path with ``btl.*`` spans in ``torch.profiler``'s
trace (``btl_bloomfilter_tpu_torch/utils/trace.py``): the entry
(``btl.insert_seq`` / ``btl.contains_seq``), the staging copy
(``btl.stage.*``), the hash (``btl.hash``), the insert's route
(``btl.scatter.*``) and the gather (``btl.gather``). A device operation
belongs to the innermost ``btl.`` span that, on the thread of the host API
call that queued it (same correlation id, as in ``trace.summarize``), was
open when that call ran. A tree whose port records no span yields a
summary with no entries.

The harness's ``run.py`` keeps no event list after its own summary, so no
metric of ``BENCHMARK.json`` reads ``summarize`` yet; the operator reads a
trace file with it (the port's CLIs write one with ``--trace FILE``):

    python3 -m portbench.spans TRACE.json

The port's counters need no trace: ``profiled_counts()`` reads the ones it
took while a profiler ran, which in ``run.py`` is the traced window alone.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import sys

from .trace import CALL, DEVICE_CATS, WINDOW, _clip, _union

PREFIX = "btl."
ENTRIES = ("btl.insert_seq", "btl.contains_seq")
STAGE = "btl.stage."


@dataclasses.dataclass
class Spans:
    window_s: float
    calls: int             # the harness's CALL annotations in the window
    entries: dict          # entry span -> how many start in the window
    spans: dict            # every btl. span -> how many start in the window
    kernel_s: dict         # innermost span -> device s of its kernels
    copy_s: dict           # innermost span -> device s of its copies, memsets
    call_device_s: float   # device s of every operation queued inside calls
    uncovered_s: float     # ... of those queued inside no btl. span
    idle_stage_s: float    # no kernel running, the host inside btl.stage.*
    idle_s: dict           # no kernel running, by the host's innermost span


def _innermost(spans, queries):
    """For each (thread, t) of ``queries``, the name of the innermost span
    of ``spans`` ({thread: [(start, end, name)]}, properly nested on each
    thread) open at t, else None. A sweep over each thread's spans."""
    out = [None] * len(queries)
    by_thread = collections.defaultdict(list)
    for i, (tid, t) in enumerate(queries):
        by_thread[tid].append((t, i))
    for tid, qs in by_thread.items():
        todo = sorted(spans.get(tid, ()), key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for t, i in sorted(qs):
            while j < len(todo) and todo[j][0] <= t:
                while stack and stack[-1][1] < todo[j][0]:
                    stack.pop()
                stack.append(todo[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[i] = stack[-1][2] if stack else None
    return out


def _segments(spans):
    """The time ``spans`` (properly nested) cover, cut into (start, end,
    name) pieces, each named after the innermost span open there."""
    out, stack, t = [], [], 0.0
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            out.append((t, stack[-1][1], stack[-1][2]))
            t = stack.pop()[1]
        if stack:
            out.append((t, a, stack[-1][2]))
        stack.append((a, b, name))
        t = a
    while stack:
        out.append((t, stack[-1][1], stack[-1][2]))
        t = stack.pop()[1]
    return [s for s in out if s[1] > s[0]]


def _overlap_by_name(segments, intervals) -> collections.Counter:
    """Length of each named segment's intersection with ``intervals``
    (both sorted and disjoint), summed by name."""
    out, j = collections.Counter(), 0
    for a, b, name in segments:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out[name] += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return out


def _clip_spans(spans, lo, hi):
    return [(max(a, lo), min(b, hi), n) for a, b, n in spans
            if b > lo and a < hi]


def _window(events):
    """(start, end) of the harness's window annotation, else of the stretch
    from the first port entry span's start to the last one's end, else
    None."""
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") == WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    entries = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "user_annotation"
               and e.get("name") in ENTRIES and "dur" in e]
    if not entries:
        return None
    return min(a for a, _ in entries), max(b for _, b in entries)


def summarize(events: list[dict]) -> Spans | None:
    """The window's device time by port span, or None when the trace holds
    neither a window nor a port entry span."""
    window = _window(events)
    if window is None:
        return None
    lo, hi = window
    spans = collections.defaultdict(list)
    counts, calls = collections.Counter(), []
    for e in events:
        if e.get("cat") != "user_annotation" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        name = e.get("name", "")
        if name == CALL and lo <= a <= hi:
            calls.append((a, b))
        if not name.startswith(PREFIX):
            continue
        spans[e.get("tid")].append((a, b, name))
        if lo <= a <= hi:
            counts[name] += 1
    calls.sort()
    starts = [a for a, _ in calls]

    def in_call(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and calls[i][0] <= t <= calls[i][1]

    queued = {e["args"]["correlation"]: (e.get("tid"), float(e["ts"]))
              for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        q = queued.get(e.get("args", {}).get("correlation"))
        dev.append((e["cat"], a, b, q))
    owners = _innermost(spans, [q for *_, q in dev if q is not None])
    kernel_s, copy_s = collections.Counter(), collections.Counter()
    kernels, call_s, uncovered = [], 0.0, 0.0
    it = iter(owners)
    for cat, a, b, q in dev:
        if cat == "kernel":
            kernels.append((a, b))
        if q is None:
            continue
        owner = next(it)
        dur = (b - a) * 1e-6
        if owner is not None:
            (kernel_s if cat == "kernel" else copy_s)[owner] += dur
        if in_call(q[1]):
            call_s += dur
            if owner is None:
                uncovered += dur
    idle, t = [], lo
    for a, b in _clip(_union(kernels), lo, hi) + [(hi, hi)]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    # the host's side: the thread that ran the most entry spans
    host = max(spans, default=None, key=lambda tid: sum(
        s[2] in ENTRIES for s in spans[tid]))
    idle_by = _overlap_by_name(_segments(_clip_spans(spans.get(host, ()), lo, hi)),
                               idle)
    idle_by["outside"] = sum(b - a for a, b in idle) - sum(idle_by.values())
    return Spans(
        window_s=(hi - lo) * 1e-6, calls=len(calls),
        entries={n: counts[n] for n in ENTRIES if counts[n]},
        spans=dict(counts), kernel_s=dict(kernel_s), copy_s=dict(copy_s),
        call_device_s=call_s, uncovered_s=uncovered,
        idle_stage_s=sum(v for n, v in idle_by.items()
                         if n.startswith(STAGE)) * 1e-6,
        idle_s={n: v * 1e-6 for n, v in idle_by.items()})


def per_entry_ms(spans: Spans | None, entry: str, name: str):
    """Device ms of the kernels queued inside the span ``name`` or its
    kinds (``name.*``), per ``entry`` span in the window; None when the
    window holds no such entry."""
    if spans is None or not spans.entries.get(entry):
        return None
    s = sum(v for n, v in spans.kernel_s.items()
            if n == name or n.startswith(name + "."))
    return s / spans.entries[entry] * 1e3


def profiled_counts() -> dict | None:
    """The counts the port took while a profiler ran
    (``utils.trace.profiled_counters()``), or None for a tree whose port
    keeps none."""
    try:
        from btl_bloomfilter_tpu_torch.utils import trace as port_trace
    except ImportError:
        return None
    read = getattr(port_trace, "profiled_counters", None)
    return read() if read is not None else None


def pageable_pct(counts: dict | None):
    """Share of the bytes staged (``stage_bytes.*``) that came from
    pageable host memory; None when nothing was staged."""
    if not counts:
        return None
    staged = sum(v for k, v in counts.items()
                 if k.startswith("stage_bytes."))
    if not staged:
        return None
    return 100.0 * counts.get("stage_bytes.pageable", 0) / staged


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a torch.profiler Chrome trace by the port's "
        "btl. spans and print it as one JSON line.")
    ap.add_argument("trace", help="the trace file (e.g. written by the "
                    "port's write_bloom / test_bloom --trace FILE)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        data = json.load(f)
    s = summarize(data["traceEvents"] if isinstance(data, dict) else data)
    if s is None:
        print("the trace holds neither a window nor a port entry span",
              file=sys.stderr)
        return 1
    print(json.dumps(dataclasses.asdict(s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
