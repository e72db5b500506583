"""Spans and counters inside the port's Bloom and counting paths.

``span(name)`` marks a stretch of host time in ``torch.profiler``'s trace:
a ``record_function`` while a profiler runs, one shared null context
otherwise (under a microsecond, against some 15 for ``record_function``).
A span lands in the profiler's own trace, on its clock, so the correlation
ids there link every device operation to the span that queued it. Every
span name starts with ``btl.``. The Bloom path records, per call:

  * ``btl.insert_seq`` / ``btl.contains_seq``  - the batch (``kmer_bloom``)
  * ``btl.stage.pageable`` / ``.pinned`` / ``.none`` - the codes moved to
    the filter's device, named by ``stage_kind``
  * ``btl.stage.ring`` - the host's part of one chunk staged through the
    device's staging ring (``utils/staging.py``), which takes a pageable
    batch's place on a CUDA device
  * ``btl.hash``     - ``nthash_scan.positions_planes``
  * ``btl.scatter.direct`` / ``.tiled`` / ``.plain`` - ``scatter_or``, named
    after the route it takes (``plain``: the CPU version)
  * ``btl.gather``   - ``gather_words``

The counting filter's sequence entries (``models/counting.py``) record the
same entry spans and ``calls.*`` counters and the same staging, and an
insert records:

  * ``btl.count.decompose`` - the decomposition: the (position, frame)
    pair sort and the flags, around
  * ``btl.count.group``     - the sort of frames by position multiset
  * ``btl.count.closed``    - the closed-form conservative step
  * ``btl.count.replay``    - the replay's rounds (the whole-batch replay
    included)

with the counters ``count.frames`` (valid frames), ``count.closed_frames``
and ``count.replayed_frames`` (their sum is ``count.frames``),
``count.steps`` (conservative steps: the closed form and every round) and
``count.whole_batch_replays`` (batches past ``max_entangled``). A batch's
valid frames are a device read where the closed form runs, so there
``count.frames`` and ``count.closed_frames`` are added only while a
profiler runs (``profiling()``): the identity holds in
``profiled_counters()``, and in ``counters()`` where every insert ran
under a profiler.

The tiled route launches its partition and its apply in one C call, so no
span splits them; the device trace names their kernels.

Counters are host integers, always on: an add never reads the device or
waits for it (a count that needs such a read is taken only under a
profiler, as the two counting ones above). ``counters()`` returns them with the kernels' launch counts
(``launches.<name>``); ``profiled_counters()`` returns the part of them
added while a profiler ran, so a profiled stretch reads its own counts
beside its trace; ``reset_counters()`` clears all three.

``profiled(path, device)`` is the CLIs' ``--trace FILE``: the loop inside
it runs under ``torch.profiler``, whose Chrome trace goes to ``path``.
"""

from __future__ import annotations

import contextlib
import json
import sys

import torch

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled

NAMES = ("calls.insert_seq", "calls.contains_seq",
         "stage_bytes.pageable", "stage_bytes.pinned", "stage_bytes.none",
         "stage_bytes.ring", "stage.chunks", "stage.slot_waits",
         "windows", "positions",
         "route.direct", "route.tiled", "route.plain", "tiles", "gathers",
         "count.frames", "count.closed_frames", "count.replayed_frames",
         "count.steps", "count.whole_batch_replays")
COUNTS = dict.fromkeys(NAMES, 0)
PROFILED = dict.fromkeys(NAMES, 0)


def profiling() -> bool:
    """Whether a ``torch.profiler`` is running."""
    return _profiling()


def span(name: str):
    """A context manager marking ``name`` in a running profiler's trace,
    else the shared null context."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n
    if _profiling():
        PROFILED[name] += n


def counters() -> dict:
    """A snapshot of every count: the ones above and
    ``launches.<kernel>`` for each kernel of ``kernels.launch_counts()``."""
    from .. import kernels
    out = dict(COUNTS)
    out.update((f"launches.{k}", v)
               for k, v in kernels.launch_counts().items())
    return out


def profiled_counters() -> dict:
    """A snapshot of the counts added while a profiler ran, since the last
    ``reset_counters()``."""
    return dict(PROFILED)


def reset_counters() -> None:
    from .. import kernels
    for name in NAMES:
        COUNTS[name] = PROFILED[name] = 0
    kernels.reset_launch_counts()


def stage_kind(codes, device: torch.device) -> str:
    """What moving ``codes`` to ``device`` copies: "pageable" (a numpy
    array, a list or an unpinned CPU tensor going to a CUDA device),
    "pinned" (a pinned CPU tensor going there) or "none" (a CPU filter, or
    codes already on a CUDA device)."""
    if device.type != "cuda":
        return "none"
    if isinstance(codes, torch.Tensor):
        if codes.device.type == "cuda":
            return "none"
        return "pinned" if codes.is_pinned() else "pageable"
    return "pageable"


@contextlib.contextmanager
def profiled(path: str | None, device: torch.device):
    """Profile the body into a Chrome trace at ``path`` (CPU activity, and
    CUDA's on a CUDA ``device``), then print the body's counters as one
    JSON line on stderr. Does nothing when ``path`` is None."""
    if path is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    print("counters " + json.dumps(counters()), file=sys.stderr)
