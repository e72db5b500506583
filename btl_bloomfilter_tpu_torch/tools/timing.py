"""CUDA-event timing of a call on a card, as ``chip_smoke.py`` and
``tools/time_kernels.py`` both time it.

Two readings of one call:

  * issued: back-to-back calls as the host issues them, as a batch loop
    runs them; for a call under about 0.1 ms this includes the wrapper's
    Python, since the card waits for the host;
  * on the card: the same calls queued while the card first spins for
    ``QUEUE_CYCLES``, so the events time the card's work alone;

and, on the host clock, the time the host takes to issue one call
(``host_ms``).

This module imports only numpy and torch, so ``tools/time_kernels.py`` can
load it by path beside a package imported from another tree.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

REPS, INNER = 7, 20
# cycles (about 10 ms on an H100) the card spins before a queued run, while
# the host queues the calls
QUEUE_CYCLES = 20_000_000


def median_ms(fn, reps: int = REPS, inner: int = INNER,
              queued: bool = False, setup=None) -> float:
    """Milliseconds per call: the median over reps of CUDA-event time
    around ``inner`` back-to-back calls, divided by ``inner``, after a
    warm-up call. Back-to-back calls let the host issue the next call while
    the card runs this one, as a batch loop does. With ``queued`` the card
    first spins for QUEUE_CYCLES while the host queues the calls, so the
    events time the card's work and not the host's issue of it. ``setup``,
    if given, runs before the warm-up and before each repetition, outside
    the events (to restore a fixed start state)."""
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


def host_ms(fn, reps: int = REPS, calls: int = 100) -> float:
    """Milliseconds of host time to issue one call: the wrapper's Python
    and the launch, on the host clock. The median over reps of ``calls``
    calls queued while the card spins (so no call waits for the card),
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(QUEUE_CYCLES)
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - start) * 1e3 / calls)
        torch.cuda.synchronize()
    return float(np.median(times))


@dataclasses.dataclass(frozen=True)
class KernelTimes:
    """A call's milliseconds as issued and on the card."""
    issued: float
    card: float

    def __format__(self, spec: str) -> str:
        return f"{self.issued:{spec}} (card {self.card:{spec}})"


def kernel_times(fn, reps: int = REPS, inner: int = INNER,
                 setup=None) -> KernelTimes:
    """``fn`` timed as issued and with its calls queued (``setup`` as
    median_ms takes it)."""
    return KernelTimes(median_ms(fn, reps, inner, setup=setup),
                       median_ms(fn, reps, inner, queued=True, setup=setup))
