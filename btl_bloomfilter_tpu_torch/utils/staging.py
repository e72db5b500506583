"""The staging ring: a pageable host batch of codes to the card, overlapped
with the kernels that read it.

A pageable copy (``tensor.to(device)`` from a numpy batch) is staged by the
driver through its own bounce buffer while the host waits, and then the
host waits again for the stream: no kernel runs and none is launched while
it lasts. The ring takes its place for a pageable batch going to a CUDA
device. Each CUDA device has one ``Ring`` (``ring(device)``, made on first
use): ``SLOTS`` pinned host slots of ``CHUNK_BYTES``, as many device slots,
and one copy stream. A batch [B, L] is cut into row pieces (``plan``); the
host copies each piece into a free pinned slot (a plain host copy, on one
thread for a query's chunks and on torch's threads for an insert: ``_put``;
so the caller's array is free again when the call returns), and the copy stream
moves it to a device slot (``non_blocking``) and records an event, which
the compute stream (the current one, where every kernel launches) waits on
before the hash. Slots are reused in stream order both ways:

  * a pinned slot is overwritten once the copy that read it has ended (the
    host waits there, and only there: ``stage.slot_waits``);
  * a device slot is overwritten once the compute stream has passed an
    event recorded right after the hash that read it.

No ordering is left to the caching allocator: the slots are the ring's for
the life of the process, made on the copy stream, and never grow. A batch
staged whole (``split`` False) that is larger than a slot lands in a buffer
of its own, made on the copy stream for that call and marked used on the
compute stream (``record_stream``), so the allocator hands its block out
again only once the kernels that read it have ended; the ring keeps
nothing of it.

Counters (``utils/trace.py``): ``stage_bytes.ring`` (bytes copied to the
card from the ring), ``stage.chunks`` (piece copies issued),
``stage.slot_waits``; the host's part of each chunk runs in a
``btl.stage.ring`` span.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import trace

CHUNK_BYTES = 4 << 20
SLOTS = 3

_RINGS: dict[int, "Ring"] = {}
_RINGS_LOCK = threading.Lock()


def plan(rows: int, row_bytes: int,
         chunk_bytes: int) -> list[tuple[int, int]]:
    """Row ranges [(start, stop), ...] that cover rows 0 .. rows - 1 once
    and in order: as few as hold at most ``chunk_bytes`` each (one row when
    a row alone is larger), their lengths at most one row apart."""
    if rows <= 0:
        return []
    per = max(1, chunk_bytes // max(1, row_bytes))
    n = -(-rows // per)
    q, r = divmod(rows, n)
    out, a = [], 0
    for i in range(n):
        b = a + q + (i < r)
        out.append((a, b))
        a = b
    return out


def takes(flat: torch.Tensor, device: torch.device) -> bool:
    """Whether codes ``flat`` [B, L] reach ``device`` through the ring: a
    pageable host batch (``trace.stage_kind``) going to a CUDA device, with
    at least one element and rows that fit a slot. Pinned or CUDA codes
    and CPU filters keep their single copy (or none)."""
    return (trace.stage_kind(flat, device) == "pageable" and flat.numel() > 0
            and flat.shape[1] * flat.element_size() <= CHUNK_BYTES)


STAGE_SPANS = {k: f"btl.stage.{k}" for k in ("pageable", "pinned", "none")}
STAGE_BYTES = {k: f"stage_bytes.{k}" for k in STAGE_SPANS}


def codes_on(device: torch.device, codes: torch.Tensor, fn,
             split: bool = False):
    """Yield ``fn(chunk)`` for row chunks of ``codes`` [..., L] flattened
    to [B, L] and put on ``device`` (a filter's), in row order; ``fn`` is
    handed device codes [n, L] and must queue every read of them. The one
    way the filters' sequence entries (``models/kmer_bloom``,
    ``models/counting``) move a batch to their device.

    A pageable host batch for a CUDA device (``takes``) goes through the
    device's ring: copied on the host into pinned slots, then to the card
    on the ring's copy stream, which ``fn``'s stream waits for. It is
    staged in ``plan``'s chunks when ``split``, else as one chunk, and
    counted under ``stage_bytes.ring``. Other codes are one chunk, moved
    with ``to`` in a ``btl.stage.*`` span named by ``trace.stage_kind`` and
    counted under ``stage_bytes.*``. The host reads ``codes`` only while
    the generator runs, and nothing the card reads afterwards aliases
    them: a caller that exhausts it may reuse its array once it returns."""
    kind = trace.stage_kind(codes, device)
    flat = codes.reshape(-1, codes.shape[-1])
    if takes(flat, device):
        yield from ring(device).map(fn, flat, split)
        return
    with trace.span(STAGE_SPANS[kind]):
        trace.count(STAGE_BYTES[kind], flat.numel() * flat.element_size())
        flat = flat.to(device)
    yield fn(flat)


def ring(device: torch.device) -> "Ring":
    """The ring of CUDA ``device`` (a tensor's device: its index is set),
    made on first use."""
    with _RINGS_LOCK:
        if device.index not in _RINGS:
            _RINGS[device.index] = Ring(device)
        return _RINGS[device.index]


class Ring:
    """``SLOTS`` pinned host slots and as many device slots, each of
    ``CHUNK_BYTES``, one copy stream, and the events that order their
    reuse."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.host = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(SLOTS)]
        # made on the copy stream, the first to write them
        with torch.cuda.stream(self.stream):
            self.dev = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                    device=device) for _ in range(SLOTS)]
        # copied[i]: the copy stream past the last copy that read host[i];
        # released[i]: the compute stream past the last read of dev[i]
        self.copied = [torch.cuda.Event() for _ in range(SLOTS)]
        self.released = [torch.cuda.Event() for _ in range(SLOTS)]
        self.next_host = self.next_dev = 0
        self.lock = threading.Lock()

    def map(self, fn, flat: torch.Tensor, split: bool):
        """Yield ``fn(codes)`` for each chunk of host codes ``flat`` [B, L]
        staged to the device, in row order: the chunks of ``plan`` when
        ``split``, else one chunk of every row (staged in ``plan``'s pieces).
        ``fn`` runs on the current stream and must queue every read of the
        chunk it is given: the chunk's device slot is released as it
        returns. One caller at a time holds the ring, from the first chunk
        to the generator's end."""
        row_bytes = flat.shape[1] * flat.element_size()
        pieces = plan(flat.shape[0], row_bytes, CHUNK_BYTES)
        with self.lock:
            for group in ([p] for p in pieces) if split else [pieces]:
                with trace.span("btl.stage.ring"):
                    d, codes = self._put(flat, group, row_bytes, split)
                try:
                    out = fn(codes)
                finally:
                    if d is not None:
                        self.released[d].record(
                            torch.cuda.current_stream(self.device))
                yield out

    def _put(self, flat: torch.Tensor, pieces, row_bytes: int,
             one_thread: bool):
        """Copy rows ``pieces[0][0]`` .. ``pieces[-1][1]`` of ``flat`` into
        the next device slot, or into a buffer of the call's own where they
        are larger than a slot, piece by piece through the pinned slots; the
        current stream waits for the last copy. Returns (slot, codes), the
        slot None for a buffer of the call's own.

        The host copies a piece on one thread (numpy) when ``one_thread``,
        else on torch's intra-op threads. A split batch takes one thread:
        each chunk's copy runs under the kernels of the chunk before, and a
        copy that waits for every core of a shared host stalls now and then,
        which its caller, waiting for the batch, feels (on an H100 host of 8
        cores: a query batch's p95 5.6 ms one thread, 7.3-8.0 threaded, at
        the same rate). A one-chunk insert takes the threads: its copy is
        what keeps the card fed from call to call (4.5e9 against 3.6e9
        k-mers/s one thread)."""
        a, b = pieces[0][0], pieces[-1][1]
        need = (b - a) * row_bytes
        compute = torch.cuda.current_stream(self.device)
        if need > CHUNK_BYTES:
            d = None
            with torch.cuda.stream(self.stream):
                buf = torch.empty(need, dtype=torch.uint8, device=self.device)
            buf.record_stream(compute)
        else:
            d = self.next_dev
            self.next_dev = (d + 1) % SLOTS
            buf = self.dev[d]
            self.stream.wait_event(self.released[d])
        dst = buf[:need].view(flat.dtype).view(b - a, flat.shape[1])
        for r0, r1 in pieces:
            h = self.next_host
            self.next_host = (h + 1) % SLOTS
            if not self.copied[h].query():
                trace.count("stage.slot_waits")
                self.copied[h].synchronize()
            n = (r1 - r0) * row_bytes
            src = self.host[h][:n].view(flat.dtype).view(r1 - r0,
                                                          flat.shape[1])
            if one_thread:
                np.copyto(src.numpy(), flat[r0:r1].numpy())
            else:
                src.copy_(flat[r0:r1])
            with torch.cuda.stream(self.stream):
                dst[r0 - a:r1 - a].copy_(src, non_blocking=True)
            self.copied[h].record(self.stream)
            trace.count("stage.chunks")
            trace.count("stage_bytes.ring", n)
        compute.wait_event(self.copied[h])
        return d, dst
