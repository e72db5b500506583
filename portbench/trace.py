"""Reading ``torch.profiler``'s Chrome trace of a window.

The harness marks the window with the annotation ``WINDOW`` and each call
into the port with ``CALL``. A device operation (kernel, copy, memset) is
"inside a call" when the host API call that queued it (same correlation
id) ran inside a ``CALL`` annotation: so every kernel the port launches,
its own or PyTorch's, counts, and the harness's own work (zeroing the
filter, reducing counts, copying them back) does not.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

WINDOW = "portbench.window"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Summary:
    window_s: float          # the WINDOW annotation's length
    busy_s: float            # union of every device operation in the window
    kernel_s: float          # union of kernels alone (copies are idle SMs)
    call_kernel_s: float     # kernels queued inside calls, summed
    call_h2d_s: float        # host-to-device copies queued inside calls
    calls: int
    device_ops: list         # [[name, seconds], ...] largest first
    idle_gaps: list          # [[what the host did, seconds], ...]


def export(prof) -> list[dict]:
    """The profiler's events, through a Chrome trace in a temporary file."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:120]
    return name[:120]


def _union(intervals) -> list[tuple[float, float]]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def summarize(events: list[dict], top: int = 10) -> Summary | None:
    """The window's device time, or None when the trace holds no window or
    no device operation."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not win or not dev:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == CALL and lo <= float(e["ts"]) <= hi)
    starts = [a for a, _ in calls]

    def in_call(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and calls[i][0] <= t <= calls[i][1]

    queued_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans, kernels, by_name = [], [], collections.Counter()
    call_kernel = call_h2d = 0.0
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo or a >= hi:
            continue
        spans.append((a, b))
        dur = (min(b, hi) - max(a, lo)) * 1e-6
        by_name[short_name(e["name"]) if e["cat"] == "kernel"
                else e["name"]] += dur
        inside = in_call(queued_at.get(e.get("args", {}).get("correlation"),
                                       float("nan")))
        if e["cat"] == "kernel":
            kernels.append((a, b))
            if inside:
                call_kernel += float(e["dur"]) * 1e-6
        elif inside and e["name"].startswith("Memcpy HtoD"):
            call_h2d += float(e["dur"]) * 1e-6
    busy = _clip(_union(spans), lo, hi)
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    return Summary(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernel_s=sum(b - a for a, b in _clip(_union(kernels), lo, hi)) * 1e-6,
        call_kernel_s=call_kernel, call_h2d_s=call_h2d, calls=len(calls),
        device_ops=[[n, s] for n, s in by_name.most_common(top)],
        idle_gaps=_label_gaps(events, gaps, top))


def _label_gaps(events, gaps, top, lookback: int = 256):
    """Idle seconds summed by what the host was doing when each gap began:
    the innermost host event open at that moment (the latest to start
    among the ``lookback`` before it), else "python between calls"."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    out = collections.Counter()
    for a, b in gaps:
        label = "python between calls"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(i - lookback, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        out[label[:120]] += (b - a) * 1e-6
    return [[n, s] for n, s in out.most_common(top)]
