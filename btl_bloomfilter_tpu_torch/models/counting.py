"""Counting Bloom filter with conservative update, as a torch tensor.

Semantics are the reference's ``models/counting.py``
(CountingBloomFilter.hpp):

  * membership = (min of the h counters) >= count_threshold;
  * ``insert`` = conservative update (incrementMin): increment every
    counter of the frame that equals the frame's minimum, and nothing once
    the minimum is at the counter's maximum (no wraparound);
  * ``insert_all`` = incrementAll: every counter of every frame, once per
    occurrence, saturating at the maximum.

Storage: widths 1, 2 and 4 bytes are packed little-endian lanes of an
``int32`` word tensor (uint32 bits), ``per = 4 // width`` counters per
word, as in the reference, so the words' bytes are the reference's counter
array. Width 8 is one ``int64`` plane holding the uint64 bits (the
reference keeps two uint32 planes); its bytes are the same.

Unlike the reference, whose functions return a new filter, every update
here works in place on ``cbf.counters`` (and returns ``cbf``): at 2**30
counters a copy per batch would move 1 GiB for nothing.

Conservative update depends on stream order. ``insert`` keeps the
reference's batched decomposition, which is bit-identical to stream order:
group frames by position multiset (``group_duplicates``), flag groups that
share a position with another group ("entangled") and frames that are the
stream-first user of every position they touch, apply the closed form
``max(cur, min + min(c, max - min))`` to untangled groups and stream-first
frames at once, and replay the rest in rounds of position-disjoint frames.
The sorts are torch sorts. Each conservative step of widths 1/2/4 (the
closed form, and every replay round) is one launch of the CUDA kernel
``kernels/conservative_step`` when the counters lie on a GPU (gather, min,
target and a carry-free add per lane in one pass), its plain version on the
CPU; queries go through ``kernels/gather_counters`` and incrementAll
through ``kernels/scatter_add``. Width 8 is plain torch on every device, as
it is in the reference, which never routes it to a kernel.

Two things differ from the reference's decomposition, neither in result:
the replay scheduler runs to its fixpoint with no round cap (the reference
caps it at 32 rounds and replays longer chains frame by frame); and when
more frames need the replay than ``max_entangled`` allows, the whole batch
is replayed in the same rounds from the state before the batch, where the
reference runs a per-frame scan.

The sequence entries (``insert_seq``, ``contains_seq``, ``min_count_seq``)
move a batch to the filter's device through ``staging.codes_on``, as
``kmer_bloom``'s do: a pageable host batch bound for a CUDA filter takes the
device's staging ring in row chunks, each hashed by the ntHash kernel's
positions mode, and the decomposition then works on the whole batch. Each
call records its entry span (``btl.insert_seq`` / ``btl.contains_seq``,
with ``calls.*``), and an insert the spans ``btl.count.decompose`` (the
decomposition, the pair sort and flags; the multiset sort in
``btl.count.group`` inside it), ``btl.count.closed`` (the closed-form
step) and ``btl.count.replay`` (the rounds, the whole-batch replay
included), and the counters
``count.frames`` (valid frames) = ``count.closed_frames`` +
``count.replayed_frames``, ``count.steps`` (conservative steps: the closed
form and every round) and ``count.whole_batch_replays``
(``utils/trace.py``). The valid frames of a batch that takes the closed
form are a read of the device: ``count.frames`` and
``count.closed_frames`` count such batches only while a profiler runs, so
an insert outside one adds no read or wait for its counters.

Counter positions come in the Bloom filter's two forms
(``bloom.position_dtype``): below 2**32 counters int32 holding uint32 bits
with the sentinel 0xFFFFFFFF; at exactly 2**32 counters, where 0xFFFFFFFF
is a real counter, int64 with the sentinel -1, through the kernels' wide
instantiations. The functions that take position planes accept either form
at any size (the narrow form's 0xFFFFFFFF is always the sentinel). The
JAX package uses 0xFFFFFFFF as its sentinel at 2**32 counters too, and so
never counts counter 2**32 - 1; this port does. Larger filters raise
``ValueError``, as the JAX package's do. Inside the decomposition positions
are int64 with the sentinel -1 at every size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import (conservative_step, gather_counters, nthash_scan,
                       scatter_add)
from ..kernels.conservative_step import earlier_dup_mask
from ..ops import u64
from ..ops.replay import STREAM_BITS, STREAM_MASK, replay_depth
from ..utils import staging, trace
from . import bloom

# the most counters a filter takes, as in the JAX package
MAX_SIZE = 1 << 32

_NP_LE = {1: "<u1", 2: "<u2", 4: "<u4", 8: "<u8"}
_PER_WORD = {1: 4, 2: 2, 4: 1, 8: 1}
_SUB_SHIFT = {4: 2, 2: 1, 1: 0}  # log2(counters per word)


@dataclasses.dataclass
class CountingBloomFilter:
    """Counting Bloom filter state."""

    counters: torch.Tensor   # widths 1/2/4: int32[nwords] packed words
    #                          (uint32 bits, little-endian lanes); width 8:
    #                          int64[size] (uint64 bits)
    size: int                # number of counters
    hash_num: int
    kmer_size: int
    count_threshold: int
    counter_width: int       # bytes per counter: 1, 2, 4 or 8
    bits_per_counter: int = 8  # header field; the reference hardcodes 8

    @property
    def size_in_bytes(self) -> int:
        return self.size * self.counter_width

    @property
    def is_u64(self) -> bool:
        return self.counter_width == 8

    @property
    def counter_max(self) -> int:
        return (1 << (8 * self.counter_width)) - 1

    @property
    def counters_per_word(self) -> int:
        return _PER_WORD[self.counter_width]

    @property
    def nwords(self) -> int:
        return self.size // self.counters_per_word

    @property
    def device(self) -> torch.device:
        return self.counters.device

    def counter_bytes(self) -> bytes:
        """The reference's little-endian counter array."""
        arr = self.counters.cpu().numpy()
        return arr.view(np.uint64 if self.is_u64 else np.uint32).astype(
            "<u8" if self.is_u64 else "<u4").tobytes()


def _check_width(counter_width: int) -> None:
    if counter_width not in _PER_WORD:
        raise ValueError(f"unsupported counter width {counter_width}")


def create(size_in_bytes: int, hash_num: int, kmer_size: int,
           count_threshold: int, counter_width: int = 1, *,
           device="cuda") -> CountingBloomFilter:
    """Empty filter on ``device``. As the reference's constructor,
    size_in_bytes is rounded up to a multiple of 8 and
    size = size_in_bytes / counter_width."""
    _check_width(counter_width)
    size_in_bytes += -size_in_bytes % 8
    size = size_in_bytes // counter_width
    if counter_width == 8:
        counters = torch.zeros(size, dtype=torch.int64, device=device)
    else:
        counters = torch.zeros(size_in_bytes // 4, dtype=torch.int32,
                               device=device)
    return CountingBloomFilter(
        counters=counters, size=size, hash_num=hash_num, kmer_size=kmer_size,
        count_threshold=count_threshold, counter_width=counter_width)


def from_bytes(buf: bytes, *, size: int, hash_num: int, kmer_size: int,
               count_threshold: int, counter_width: int,
               bits_per_counter: int = 8,
               device="cuda") -> CountingBloomFilter:
    """A filter over the reference's counter array (``size`` counters of
    ``counter_width`` little-endian bytes)."""
    _check_width(counter_width)
    if counter_width == 8:
        arr = np.frombuffer(buf, dtype="<u8", count=size).astype(np.uint64)
        counters = torch.from_numpy(arr.view(np.int64).copy())
    else:
        arr = np.frombuffer(buf, dtype="<u4", count=size * counter_width // 4)
        counters = torch.from_numpy(arr.astype(np.uint32).view(np.int32))
    return CountingBloomFilter(
        counters=counters.to(device), size=size, hash_num=hash_num,
        kmer_size=kmer_size, count_threshold=count_threshold,
        counter_width=counter_width, bits_per_counter=bits_per_counter)


def to_numpy(cbf: CountingBloomFilter) -> np.ndarray:
    """Per-counter host view: numpy uint8/16/32/64 [size], the array the
    reference's ``m_filter`` holds."""
    return np.frombuffer(cbf.counter_bytes(),
                         dtype=_NP_LE[cbf.counter_width]).copy()


def from_numpy_counters(counters: np.ndarray, *, size: int, hash_num: int,
                        kmer_size: int, count_threshold: int,
                        counter_width: int, bits_per_counter: int = 8,
                        device="cuda") -> CountingBloomFilter:
    """A filter over the JAX package's counter state
    (``np.asarray(jax_cbf.counters)``): packed uint32 words [size * width
    / 4] for widths 1/2/4, the [2, size] uint32 planes (low, high) for
    width 8. The data is copied."""
    _check_width(counter_width)
    arr = np.asarray(counters, dtype=np.uint32)
    if counter_width == 8:
        if arr.shape != (2, size):
            raise ValueError(f"expected [2, {size}] planes, got {arr.shape}")
        full = arr[0].astype(np.uint64) | (arr[1].astype(np.uint64) << 32)
        return from_bytes(full.astype("<u8").tobytes(), size=size,
                          hash_num=hash_num, kmer_size=kmer_size,
                          count_threshold=count_threshold, counter_width=8,
                          bits_per_counter=bits_per_counter, device=device)
    nwords = size * counter_width // 4
    if arr.shape != (nwords,):
        raise ValueError(f"expected {nwords} words for {size} counters of "
                         f"width {counter_width}, got shape {arr.shape}")
    return from_bytes(arr.astype("<u4").tobytes(), size=size,
                      hash_num=hash_num, kmer_size=kmer_size,
                      count_threshold=count_threshold,
                      counter_width=counter_width,
                      bits_per_counter=bits_per_counter, device=device)


def to_numpy_counters(cbf: CountingBloomFilter) -> np.ndarray:
    """The counter state in the JAX package's layout, the inverse of
    :func:`from_numpy_counters`: uint32 words, or [2, size] uint32 planes
    for width 8."""
    if cbf.is_u64:
        full = to_numpy(cbf)
        return np.stack([(full & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         (full >> np.uint64(32)).astype(np.uint32)])
    return cbf.counters.cpu().numpy().view(np.uint32).copy()


# ---------------------------------------------------------------------------
# positions / lane arithmetic
# ---------------------------------------------------------------------------

def _check_size(cbf: CountingBloomFilter) -> None:
    if cbf.size > MAX_SIZE:
        raise ValueError(f"counting filter of {cbf.size} counters: at most "
                         "2**32")


def _positions(cbf: CountingBloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """hash % size in the form ``bloom.position_dtype(size)``, same
    shape."""
    _check_size(cbf)
    return bloom.hash_positions(hashes.to(cbf.device), cbf.size)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def _planes(cbf: CountingBloomFilter, pos: torch.Tensor) -> torch.Tensor:
    _check_size(cbf)
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError("positions must be torch.int32 (uint32 bits) or "
                        "torch.int64")
    return pos.to(cbf.device)


def min_count_sentinel_positions(cbf: CountingBloomFilter,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Minimum of the h counters per window for position planes pos [h,
    ...] (counter indices < size, int32 holding uint32 bits or int64),
    where an invalid window carries the sentinel (0xFFFFFFFF or -1) in
    every slot. Returns int64 [...] (uint64 bits for width 8); an invalid
    window reads 0."""
    pos = _planes(cbf, pos)
    if not cbf.is_u64:
        return gather_counters.gather_counters(
            cbf.counters, pos, _SUB_SHIFT[cbf.counters_per_word], "min")
    p = u64.positions64(pos)
    sent = p < 0
    vals = torch.where(sent, 0, cbf.counters[torch.where(sent, 0, p)])
    return torch.where(sent[0], 0, u64.amin(vals, dim=0))


def contains_sentinel_positions(cbf: CountingBloomFilter,
                                pos: torch.Tensor) -> torch.Tensor:
    """Membership (min count >= count_threshold) for position planes pos
    [h, ...] in either form; invalid windows are False."""
    pos = _planes(cbf, pos)
    if not cbf.is_u64:
        return gather_counters.gather_counters(
            cbf.counters, pos, _SUB_SHIFT[cbf.counters_per_word], "hit",
            cbf.count_threshold)
    mc = min_count_sentinel_positions(cbf, pos)
    thr = torch.tensor(u64.as_signed(cbf.count_threshold), device=cbf.device)
    return (pos[0] != -1) & u64.ge(mc, thr)


def min_count(cbf: CountingBloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """Minimum of the h counters per frame: hashes int64 [..., h] (uint64
    bits) -> int64 counts [...] (uint64 bits for width 8)."""
    return min_count_sentinel_positions(
        cbf, _positions(cbf, hashes).movedim(-1, 0))


def contains(cbf: CountingBloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """Membership of frames: hashes int64 [..., h] -> bool [...]."""
    return contains_sentinel_positions(
        cbf, _positions(cbf, hashes).movedim(-1, 0))


# ---------------------------------------------------------------------------
# conservative update
# ---------------------------------------------------------------------------

def _frames(cbf: CountingBloomFilter, hashes: torch.Tensor, valid):
    """Positions int64 [h, n] (counter indices, the sentinel -1 in every
    slot of an invalid frame) of hashes [..., h]."""
    h = hashes.shape[-1]
    _check_size(cbf)
    pos = u64.mod_const(hashes.to(cbf.device), cbf.size).reshape(-1, h).T
    pos = pos.contiguous()
    if valid is not None:
        v = torch.as_tensor(valid, device=cbf.device).broadcast_to(
            hashes.shape[:-1]).reshape(-1)
        pos = torch.where(v, pos, -1)
    return pos


def _packed_step(words: torch.Tensor, per: int, counter_max: int,
                 kernel=conservative_step.conservative_step,
                 wide: bool = False):
    """The conservative step on packed words, for position-disjoint
    frames p int64 [h, m] (counter indices or the sentinel -1) each repeated
    c[m] times (int64), the frames where ``live`` (bool [m], or None for
    all) is False left out: every counter becomes max(cur, mn + min(c,
    cmax - mn)), mn the frame's minimum. It is incrementMin for c = 1 and
    the closed form of c repeats of a frame (the freeze at cmax included).
    One call of ``kernel`` (conservative_step or its plain version), on
    narrow positions, or on wide ones (``wide``: a filter of 2**32
    counters)."""
    shift = _SUB_SHIFT[per]

    def step(p: torch.Tensor, c: torch.Tensor, live=None) -> None:
        # narrow: the low 32 bits, the uint32 bits (-1 becomes 0xFFFFFFFF)
        pos = p.to(torch.int64 if wide else torch.int32, copy=True)
        if live is not None:             # slot 0 the sentinel: no write
            pos[0].masked_fill_(~live, -1)
        kernel(words, pos, c, shift, counter_max)

    return step


def _u64_step(plane: torch.Tensor):
    """Width-8 twin of :func:`_packed_step` on the int64 plane (uint64
    arithmetic, freeze at 2**64-1); plain torch on every device."""

    def step(p: torch.Tensor, c: torch.Tensor, live=None) -> None:
        if live is not None:
            p = torch.where(live, p, -1)
        slot = p >= 0
        p = torch.where(slot, p, 0)
        cur = plane[p]
        mn = u64.amin(cur, dim=0)
        target = (mn + u64.min_(c, ~mn)).expand_as(cur)   # ~mn = headroom
        take = slot & ~earlier_dup_mask(p) & u64.lt(cur, target)
        plane[p[take]] = target[take]

    return step


def _replay(step, p: torch.Tensor) -> None:
    """Apply the frames p int64 [h, m] (live, in stream order) exactly as
    stream order would: one conservative step per round of
    :func:`replay_depth`."""
    if p.shape[1] == 0:
        return
    depth = replay_depth(p)
    order = torch.argsort(depth, stable=True)
    ones = torch.ones(p.shape[1], dtype=torch.int64, device=p.device)
    start = 0
    for n_round in torch.bincount(depth)[1:].tolist():
        rows = order[start:start + n_round]
        step(p[:, rows], ones[:n_round])
        trace.count("count.steps")
        start += n_round


def _entangled_cap(n: int, h: int, size: int, max_entangled) -> int:
    """Replay buffer bound, as the reference sizes it: the expected
    remainder (n*h)**2 / (2*size) plus in-frame duplicates, with margin."""
    if max_entangled is not None:
        cap = max_entangled
    else:
        expected = (n * h) ** 2 // (2 * max(size, 1))
        in_frame_dup = (n * h * (h - 1)) // (2 * max(size, 1))
        cap = max(256, expected + expected // 4 + in_frame_dup + 1024)
    return min(cap, n)


def _decompose(pos: torch.Tensor, group: bool):
    """The reference's batched decomposition (``_conservative_decompose``)
    on positions int64 [h, n] (invalid frames all sentinel). Returns
    (ks [h, n] frame rows, closed bool [n], closed_c int64 [n], remainder
    frame indices in stream order)."""
    h, n = pos.shape
    dev = pos.device
    idx = torch.arange(n, device=dev)

    # --- 1. group by identical position multiset -------------------------
    if group:
        with trace.span("btl.count.group"):
            key = _sort_slots(pos)
            perm = idx
            for j in reversed(range(h)):     # least significant key first
                perm = perm[torch.sort(key[j, perm], stable=True).indices]
            ks, frame_of = key[:, perm], perm
            new_grp = torch.ones(n, dtype=torch.bool, device=dev)
            new_grp[1:] = (ks[:, 1:] != ks[:, :-1]).any(dim=0)
            gid = torch.cumsum(new_grp, 0) - 1
            starts = torch.nonzero(new_grp).reshape(-1)
            run_len = torch.diff(starts, append=starts.new_tensor([n]))[gid]
    else:
        # every frame its own group; the frame order needs no sort
        ks, frame_of = pos, idx
        new_grp = torch.ones(n, dtype=torch.bool, device=dev)
        run_len = torch.ones(n, dtype=torch.int64, device=dev)

    # --- 2. entanglement + stream-first flags per position run -----------
    # pairs sort by (position, stream) packed into one int64 key (a
    # position below 2**32 or the sentinel -1, a stream index below 2**31:
    # the key fits, and the sentinel's pairs sort first): a run's
    # stream-first user is its first pair
    pair_key = (ks.reshape(-1) << STREAM_BITS) | frame_of.repeat(h)
    key_s, pi_s = torch.sort(pair_key)
    pp_s = key_s >> STREAM_BITS
    pg_s = gid.repeat(h)[pi_s] if group else key_s & STREAM_MASK
    same = pp_s[1:] == pp_s[:-1]
    shared_prev = torch.zeros(n * h, dtype=torch.bool, device=dev)
    shared_prev[1:] = same & (pg_s[1:] != pg_s[:-1]) & (pp_s[1:] >= 0)
    shared = shared_prev.clone()
    shared[:-1] |= shared_prev[1:]
    first = torch.ones(n * h, dtype=torch.bool, device=dev)
    first[1:] = ~same
    # (an in-frame duplicate position yields one non-first pair, sending
    # that frame to the replay instead of the closed form: still exact)
    flags = torch.empty(n * h, dtype=torch.uint8, device=dev)
    flags[pi_s] = (first.to(torch.uint8) << 1) | shared.to(torch.uint8)
    flags = flags.view(h, n)
    frame_shared = ((flags & 1) != 0).any(dim=0)
    frame_first = ((flags & 2) != 0).all(dim=0)

    # group-wide flag: any shared frame inside the run marks the whole run
    if group:
        entangled = torch.zeros(starts.numel(), dtype=torch.int64,
                                device=dev).index_add_(
            0, gid, frame_shared.to(torch.int64))[gid] > 0
    else:
        entangled = frame_shared
    live = ks[0] >= 0
    entangled &= live
    rep = new_grp & live & ~entangled
    depth1 = entangled & frame_first     # stream-first at every slot
    remainder = entangled & ~depth1
    # closed-form rows: untangled representatives (c = run occurrences)
    # plus depth-1 entangled occurrences (c = 1); position-disjoint
    closed = rep | depth1
    closed_c = torch.where(rep, run_len, 1)
    ent_frames = torch.sort(frame_of[remainder]).values
    return ks, closed, closed_c, ent_frames


def _sort_slots(p: torch.Tensor) -> torch.Tensor:
    """Each frame's positions in ascending order: p [h, n] sorted along
    dim 0 by odd-even transposition (h rounds of elementwise
    compare-exchange, which beats a segmented sort of n rows of h)."""
    rows = list(p)
    for r in range(len(rows)):
        for j in range(r % 2, len(rows) - 1, 2):
            lo = torch.minimum(rows[j], rows[j + 1])
            rows[j + 1] = torch.maximum(rows[j], rows[j + 1])
            rows[j] = lo
    return torch.stack(rows)


def _insert_frames(step, pos: torch.Tensor, size: int, max_entangled,
                   group: bool) -> None:
    """Conservative update of frames pos int64 [h, n] through ``step``,
    bit-identical to stream order."""
    h, n = pos.shape
    if n == 0:
        return
    if n >= (1 << STREAM_BITS):
        raise ValueError(f"{n} frames in one batch; at most 2**31 - 1")
    with trace.span("btl.count.decompose"):
        ks, closed, closed_c, ent_frames = _decompose(pos, group)
    n_ent = ent_frames.numel()
    if n_ent > _entangled_cap(n, h, size, max_entangled):
        # too many frames for the replay buffer: replay the whole batch in
        # rounds from the state before it (the closed form is not applied)
        live = pos[:, pos[0] >= 0]
        trace.count("count.whole_batch_replays")
        trace.count("count.frames", live.shape[1])
        trace.count("count.replayed_frames", live.shape[1])
        with trace.span("btl.count.replay"):
            _replay(step, live)
        return
    if trace.profiling():
        # the valid frames take a read of the device, so they are counted
        # only while a profiler runs; the closed form applies the rest
        n_live = int((pos[0] >= 0).sum())
        trace.count("count.frames", n_live)
        trace.count("count.closed_frames", n_live - n_ent)
    trace.count("count.replayed_frames", n_ent)
    with trace.span("btl.count.closed"):
        step(ks, closed_c, closed)
    trace.count("count.steps")
    with trace.span("btl.count.replay"):
        _replay(step, pos[:, ent_frames])


def _as_positions(pos, v) -> torch.Tensor:
    """Frame-major positions [n, h] (int64 indices, or int32 uint32 bits)
    and valid mask [n] -> int64 [h, n] with invalid frames all -1."""
    pos = torch.as_tensor(pos)
    pos = (u64.from_u32_bits(pos) if pos.dtype == torch.int32
           else pos.to(torch.int64))
    v = torch.as_tensor(v, device=pos.device).reshape(-1, 1)
    return torch.where(v, pos, -1).T.contiguous()


def insert_positions(words: torch.Tensor, pos, v, counter_max: int,
                     size: int, per_word: int, max_entangled=None,
                     group: bool = True, *,
                     step=conservative_step.conservative_step
                     ) -> torch.Tensor:
    """Position-level core of :func:`insert`: conservative update of the
    packed words (int32 [size // per_word], uint32 bits, ``per_word``
    counters per word) with frames pos [n, h] (counter indices < size;
    invalid frames masked by v bool [n]), bit-identical to stream order.
    Updates ``words`` in place and returns it.

    ``step`` applies each conservative step; passing the kernel's plain
    version (``conservative_step_plain``) runs the plain path on any
    device, which is how the kernel path is held against it on the card."""
    p = _as_positions(pos, v).to(words.device)
    wide = size >= nthash_scan.WIDE_SIZE
    _insert_frames(_packed_step(words, per_word, counter_max, step, wide),
                   p, size, max_entangled, group)
    return words


def insert_positions_u64(plane: torch.Tensor, pos, v, size: int,
                         max_entangled=None) -> torch.Tensor:
    """Width-8 twin of :func:`insert_positions` on the int64 counter plane
    (uint64 bits), grouped as the reference's is. Updates ``plane`` in
    place and returns it."""
    p = _as_positions(pos, v).to(plane.device)
    _insert_frames(_u64_step(plane), p, size, max_entangled, True)
    return plane


def _step_for(cbf: CountingBloomFilter):
    if cbf.is_u64:
        return _u64_step(cbf.counters)
    return _packed_step(cbf.counters, cbf.counters_per_word, cbf.counter_max,
                        wide=cbf.size >= nthash_scan.WIDE_SIZE)


def insert_sentinel_positions(cbf: CountingBloomFilter, pos: torch.Tensor,
                              max_entangled=None,
                              group_duplicates: bool = True
                              ) -> CountingBloomFilter:
    """Conservative update with position planes pos [h, ...] in either
    form (counter indices < size; an invalid window holds the sentinel in
    every slot), frames in row-major stream order: the array the ntHash
    kernel's positions mode writes. Updates ``cbf.counters`` in place."""
    p = u64.positions64(_planes(cbf, pos))
    _insert_frames(_step_for(cbf), p.reshape(p.shape[0], -1), cbf.size,
                   max_entangled, group_duplicates)
    return cbf


def insert(cbf: CountingBloomFilter, hashes: torch.Tensor, valid=None,
           max_entangled=None,
           group_duplicates: bool = True) -> CountingBloomFilter:
    """Batched conservative update of frames hashes int64 [..., h]
    (uint64 bits), bit-identical to inserting them one at a time in stream
    order (incrementMin). ``valid`` (bool, broadcastable to
    hashes.shape[:-1]) masks frames out.

    ``max_entangled`` bounds the replay of entangled frames (default about
    the expected number of hash collisions); past it the whole batch is
    replayed in rounds. ``group_duplicates=False`` skips the
    group-by-multiset sort: exact for any stream and cheaper on streams
    with few repeated frames, but repeated frames then replay, so keep the
    default for coverage-like input. Updates ``cbf.counters`` in place."""
    _insert_frames(_step_for(cbf), _frames(cbf, hashes, valid), cbf.size,
                   max_entangled, group_duplicates)
    return cbf


def insert_sequential(cbf: CountingBloomFilter, hashes: torch.Tensor,
                      valid=None) -> CountingBloomFilter:
    """Conservative update one frame at a time, in stream order: the
    transparent mirror of the reference's incrementMin loop. Exact but one
    step per frame; use :func:`insert` for throughput. Updates in place."""
    step = _step_for(cbf)
    pos = _frames(cbf, hashes, valid)
    one = torch.ones(1, dtype=torch.int64, device=cbf.device)
    for f in range(pos.shape[1]):
        if int(pos[0, f]) >= 0:
            step(pos[:, f:f + 1], one)
    return cbf


def insert_and_check(cbf: CountingBloomFilter, hashes: torch.Tensor,
                     valid=None):
    """Batched insertAndCheck: (cbf, found bool [...]), with membership
    taken against the state before the batch, as the reference's batched
    form does."""
    found = contains(cbf, hashes)
    return insert(cbf, hashes, valid), found


def insert_all(cbf: CountingBloomFilter, hashes: torch.Tensor,
               valid=None) -> CountingBloomFilter:
    """incrementAll: every counter of every frame, once per occurrence,
    saturating at the counter max. Order-independent, so one saturating
    scatter-add (the scatter_add kernel for widths 1/2/4 on a GPU).
    Updates in place."""
    pos = _positions(cbf, hashes)
    if valid is not None:
        v = torch.as_tensor(valid, device=cbf.device)[..., None]
        pos = torch.where(v, pos, -1)
    if not cbf.is_u64:
        scatter_add.scatter_add(cbf.counters, pos,
                                _SUB_SHIFT[cbf.counters_per_word],
                                cbf.counter_max)
        return cbf
    p = u64.positions64(pos.reshape(-1))
    p = p[p >= 0]
    uniq, occ = torch.unique(p, return_counts=True)
    cbf.counters[uniq] = u64.add_sat(cbf.counters[uniq], occ)
    return cbf


# ---------------------------------------------------------------------------
# sequence level: hash every window of a read batch, then insert or query
# ---------------------------------------------------------------------------

def _positions_seq(cbf: CountingBloomFilter, codes):
    """Position planes [h, B, W] and valid [B, W] of codes [..., L]
    flattened to [B, L], and the shape [..., W]: the ntHash kernel's
    positions mode on each row chunk that ``staging.codes_on`` puts on the
    filter's device, joined in row order.

    A pageable batch bound for a CUDA filter comes through the staging ring
    in ``staging.plan``'s chunks (``split``): the ring copies a split
    batch's pieces on one host thread, and a copy on torch's threads leaves
    them spinning into the host work every insert here does between its
    round trips (H100 host: 25.2-26.2 ms a 65,536 x 150 batch one thread,
    25.0-31.4 threaded). The positions are joined so that the decomposition
    runs once on the whole batch."""
    _check_size(cbf)
    codes = torch.as_tensor(codes)
    pos, valid = [], []
    for p, _strand, v in staging.codes_on(
            cbf.device, codes, lambda c: nthash_scan.positions_planes(
                c, cbf.kmer_size, cbf.hash_num, cbf.size), split=True):
        pos.append(p)
        valid.append(v)
    pos = pos[0] if len(pos) == 1 else torch.cat(pos, dim=1)
    valid = valid[0] if len(valid) == 1 else torch.cat(valid)
    return pos, valid, codes.shape[:-1] + valid.shape[-1:]


def insert_seq(cbf: CountingBloomFilter, codes, max_entangled=None,
               group_duplicates: bool = True) -> CountingBloomFilter:
    """Conservative update with every valid k-mer window of codes
    [..., L] (A=0 C=1 G=2 T=3, any code >= 4 an N), windows in row-major
    stream order. Updates in place."""
    trace.count("calls.insert_seq")
    with trace.span("btl.insert_seq"):
        pos, _valid, _shape = _positions_seq(cbf, codes)
        return insert_sentinel_positions(cbf, pos, max_entangled,
                                         group_duplicates)


def contains_seq(cbf: CountingBloomFilter, codes):
    """(hit bool [..., W], valid bool [..., W]) of every window of codes
    [..., L]; invalid windows are reported False."""
    trace.count("calls.contains_seq")
    with trace.span("btl.contains_seq"):
        pos, valid, shape = _positions_seq(cbf, codes)
        hit = contains_sentinel_positions(cbf, pos)
        return hit.reshape(shape), valid.reshape(shape)


def min_count_seq(cbf: CountingBloomFilter, codes):
    """(min count int64 [..., W], valid bool [..., W]) of every window of
    codes [..., L]; invalid windows read 0. A query: it records the
    ``btl.contains_seq`` span and ``calls.contains_seq``."""
    trace.count("calls.contains_seq")
    with trace.span("btl.contains_seq"):
        pos, valid, shape = _positions_seq(cbf, codes)
        mc = min_count_sentinel_positions(cbf, pos)
        return mc.reshape(shape), valid.reshape(shape)


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def _lane_count(cbf: CountingBloomFilter, pred) -> int:
    """Number of counters whose value (int64) satisfies pred, lane by lane
    on the packed words."""
    per = cbf.counters_per_word
    if per == 1:
        return int(pred(u64.from_u32_bits(cbf.counters)).sum())
    bits = 32 // per
    return sum(int(pred((cbf.counters >> (bits * j)) & ((1 << bits) - 1))
                   .sum()) for j in range(per))


def pop_count(cbf: CountingBloomFilter) -> int:
    """Non-zero counters."""
    if cbf.is_u64:
        return int((cbf.counters != 0).sum())
    return _lane_count(cbf, lambda lane: lane != 0)


def filtered_pop_count(cbf: CountingBloomFilter) -> int:
    """Counters >= count_threshold."""
    if cbf.is_u64:
        thr = torch.tensor(u64.as_signed(cbf.count_threshold),
                           device=cbf.device)
        return int(u64.ge(cbf.counters, thr).sum())
    return _lane_count(cbf, lambda lane: lane >= cbf.count_threshold)


def fpr(cbf: CountingBloomFilter) -> float:
    """(pop_count / size) ** hash_num, in double precision, as the port's
    ``bloom.get_fpr`` (the JAX package computes it in float32)."""
    return (pop_count(cbf) / cbf.size) ** cbf.hash_num


def filtered_fpr(cbf: CountingBloomFilter) -> float:
    """(filtered_pop_count / size) ** hash_num, in double precision."""
    return (filtered_pop_count(cbf) / cbf.size) ** cbf.hash_num
