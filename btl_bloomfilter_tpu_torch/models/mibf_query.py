"""MIBF read classification (MIBFQuerySupport), as torch tensors.

Semantics are the reference's ``models/mibf_query.py``
(MIBFQuerySupport.hpp): per-frame ID statistics (six counters per candidate
ID), candidate promotion, the extra-frame early exit, and the final
ranking of candidates. The engine is the reference's exact two-pass
decomposition ``query_frames_batch``:

  A. per-slot flags (seen-set firsts, saturation quirks): [R, W, h] tensor
     ops;
  B. each slot's running counts: the count of its ID after its frame, from
     one in-read sort of (ID, slot) keys, a prefix sum and two
     ``searchsorted`` lookups of the segment start and the frame's end;
  C. the sequential state (best counts, second best, early exit, candidate
     existence): the CUDA kernel ``kernels/mibf_frame_scan`` on a GPU, its
     plain frame loop on the CPU.

The dense count and candidate tables are then one ``index_add_`` and one
``index_put_`` over the reads' slots. Keys are int64, so the reference's
uint32 guard (its fallback to the dense-carry scan for large ``num_ids``
or W >= 2**16) is not needed. The frame lookups (rank, hit, ID) go through
the ``kernels/mibf_rank`` kernel. The candidate ranking (``summarize``)
runs on the host on the small tables.

Paired-end reads run the same engine over the two reads' frames
interleaved on the device (``interleave_paired_frames``);
``get_match_signature`` gives a read's per-frame match signature.
``query_scan`` / ``query_scan_batch`` are the reference's per-frame oracle
of the engine: a frame loop over a dense count table, no kernel.

A width-8 filter is not classified: the reference's engine takes IDs as
uint32 (against a uint32 saturation mask) and has no width-8 path, so the
engine, the oracle and ``get_match_signature`` raise
``NotImplementedError`` there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch

from ..kernels import mibf_frame_scan
from ..kernels.mibf_frame_scan import compare_std_err
from . import mibf as mibf_mod
from .mibf import MIBloomFilter

# count-table columns
_COUNT, _NONSAT, _TOTAL, _TOTALNONSAT, _NONSATFRAME, _SOLID = range(6)


@dataclasses.dataclass
class QueryResult:
    """Mirrors MIBFQuerySupport::QueryResult (MIBFQuerySupport.hpp:61-71)."""

    id: int
    count: int
    non_sat_count: int
    total_count: int
    total_non_sat_count: int
    non_sat_frame_count: int
    solid_count: int
    frame_prob: float


def _compare_std_err_host(a: float, b: float) -> bool:
    sa, sb = math.sqrt(a), math.sqrt(b)
    if a > b:
        return (a - sa) <= (b + sb)
    return (b - sb) <= (a + sa)


def _require_narrow(m: MIBloomFilter) -> None:
    if m.data_width == 8:
        raise NotImplementedError(
            "classification of a width-8 MIBF: the reference's query engine "
            "reads IDs as uint32 and has no width-8 path")


def query_scan_batch(m: MIBloomFilter, frame_raw, frame_hit, frame_valid,
                     frame_misses, min_count, num_ids: int,
                     extra_frame_limit: int, frame_eval=None,
                     st_mode: bool = False):
    """The reference's sequential engine (MIBFQuerySupport.hpp:430-518)
    frame by frame over R reads at once, with each read's dense [num_ids,
    6] count table as the carry: the oracle :func:`query_frames_batch` is
    held against. Takes and returns what :func:`query_frames_batch` does;
    runs on the filter's device, as plain torch."""
    _require_narrow(m)
    dev = m.device
    raw = torch.as_tensor(frame_raw).to(dev).to(torch.int64)
    hit = torch.as_tensor(frame_hit).to(dev)
    valid = torch.as_tensor(frame_valid).to(dev)
    misses = torch.as_tensor(frame_misses).to(dev)
    min_count = torch.as_tensor(min_count).to(dev).to(torch.int32)
    if frame_eval is None:
        frame_eval = torch.zeros_like(valid) if st_mode else valid
    frame_eval = torch.as_tensor(frame_eval).to(dev)
    R, W, h = raw.shape
    smask, anti = m.s_mask, m.s_anti_mask
    counts = torch.zeros((R, num_ids, 6), dtype=torch.int32, device=dev)
    cand = torch.zeros((R, num_ids), dtype=torch.bool, device=dev)
    best = torch.zeros((R, 6), dtype=torch.int32, device=dev)
    zero = torch.zeros(R, dtype=torch.int32, device=dev)
    second, extra, satc, evalc = zero, zero, zero, zero
    stopped = torch.zeros(R, dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev)
    earlier = torch.ones((h, h), dtype=torch.bool, device=dev).tril(-1)
    other = ~torch.eye(h, dtype=torch.bool, device=dev)
    for t in range(W):
        r, ht = raw[:, t], hit[:, t]                               # [R, h]
        active = valid[:, t] & ~stopped                            # [R]
        sat = r > smask
        stripped = torch.where(sat, r & anti, r)
        # seen set: the first slot of each raw value among the hit slots
        first_raw = ht & ~((r[:, None, :] == r[:, :, None]) & earlier
                           & ht[:, None, :]).any(dim=-1)
        raw_eq_stripped = r[:, None, :] == stripped[:, :, None]    # [i, j]
        earlier_pushed = (first_raw[:, None, :] & raw_eq_stripped
                          & earlier).any(dim=-1)
        inc_count_nonsat = first_raw & ~sat
        no_sat = ~(ht & sat).any(dim=-1, keepdim=True)
        delta = torch.stack([
            (first_raw & sat & ~earlier_pushed) | inc_count_nonsat,
            inc_count_nonsat, ht, ht & ~sat, first_raw & no_sat,
            first_raw & no_sat & (misses[:, t, None] == 0)], dim=-1)
        delta &= (active[:, None] & (stripped < num_ids))[..., None]
        cid = stripped.clamp(max=num_ids - 1)
        counts.view(-1, 6).index_add_(
            0, (rows[:, None] * num_ids + cid).reshape(-1),
            delta.reshape(-1, 6).to(torch.int32))
        # candidate promotion, slot by slot (MIBFQuerySupport.hpp:485-508);
        # a saturated raw whose stripped value is also in the seen set is
        # skipped; out-of-range IDs read and promote the clipped ID
        also_seen = (first_raw[:, None, :] & raw_eq_stripped & other
                     & sat[:, :, None] & ~sat[:, None, :]).any(dim=-1)
        consider = first_raw & active[:, None] & ~(sat & also_seen)
        for i in range(h):
            c = counts[rows, cid[:, i]]                            # [R, 6]
            ok = consider[:, i] & (
                (c[:, _COUNT] >= min_count[cid[:, i]])
                | (cand.any(dim=1) & (c[:, _COUNT] >= best[:, _COUNT])))
            cand[rows, cid[:, i]] |= ok
            # updateMaxCounts (MIBFQuerySupport.hpp:520-542)
            nsf, best_nsf = c[:, _NONSATFRAME], best[:, _NONSATFRAME]
            second = torch.where(ok & ~(nsf > best_nsf) & (nsf > second),
                                 nsf, second)
            up = ok[:, None] & (c > best)
            best = torch.where(up, c, best)
        satc = satc + (active & ~no_sat[:, 0]).to(torch.int32)
        evalc = evalc + (frame_eval[:, t] & ~stopped).to(torch.int32) + \
            torch.where(active, ht.sum(dim=-1, dtype=torch.int32), 0)
        # the early exit (MIBFQuerySupport.hpp:509-517): totalNonSatCount
        # against the second-best nonSatFrameCount, as the reference has it
        reset = compare_std_err(best[:, _TOTALNONSAT], second)
        extra = torch.where(active & reset, 0, extra)
        leading = best[:, _NONSATFRAME] > second
        stopped = stopped | (active & leading & (extra_frame_limit < extra))
        extra = extra + (active & leading).to(torch.int32)
    return {"counts": counts, "candidates": cand, "best": best,
            "sat_count": satc, "eval_count": evalc}


def query_scan(m: MIBloomFilter, frame_raw, frame_hit, frame_valid,
               frame_misses, min_count, num_ids: int,
               extra_frame_limit: int, frame_eval=None,
               st_mode: bool = False):
    """:func:`query_scan_batch` of one read's frames [W, h]: the tables
    without the read axis."""
    out = query_scan_batch(
        m, torch.as_tensor(frame_raw)[None], torch.as_tensor(frame_hit)[None],
        torch.as_tensor(frame_valid)[None],
        torch.as_tensor(frame_misses)[None], min_count, num_ids,
        extra_frame_limit,
        None if frame_eval is None else torch.as_tensor(frame_eval)[None],
        st_mode)
    return {k: v[0] for k, v in out.items()}


def prep_frames(m: MIBloomFilter, hashes: torch.Tensor, valid,
                max_miss: int):
    """hashes int64 [..., h] -> (raw int64, hit bool [..., h], usable bool,
    misses int32 [...]): the bit tests and rank + ID lookups of every frame
    and the frames that enter the engine (iterator-yielded and within
    ``max_miss`` misses)."""
    _, hit, raw = mibf_mod.at_rank_data(m, hashes)
    misses = (~hit).sum(dim=-1, dtype=torch.int32)
    usable = torch.as_tensor(valid).to(m.device) & (misses <= max_miss)
    return raw, hit, usable, misses


def query_device(m: MIBloomFilter, hashes: torch.Tensor, valid, min_count,
                 max_miss: int, num_ids: int, extra_frame_limit: int,
                 st_mode: bool = False):
    """One read, hashes int64 [W, h] -> the engine's tables (see
    :func:`query_frames_batch`) without the read axis."""
    out = query_device_batch(m, hashes[None], torch.as_tensor(valid)[None],
                             min_count, max_miss, num_ids, extra_frame_limit,
                             st_mode)
    return {k: v[0] for k, v in out.items()}


def query_device_batch(m: MIBloomFilter, hashes: torch.Tensor, valid,
                       min_count, max_miss: int, num_ids: int,
                       extra_frame_limit: int, st_mode: bool = False):
    """R reads, hashes int64 [R, W, h], valid bool [R, W] -> the engine's
    tables: the lookups of all R*W*h positions in one kernel pass, then
    :func:`query_frames_batch`."""
    raw, hit, usable, misses = prep_frames(m, hashes, valid, max_miss)
    ev = None if st_mode else torch.as_tensor(valid).to(m.device)
    return query_frames_batch(m, raw, hit, usable, misses, min_count,
                              num_ids, extra_frame_limit, frame_eval=ev,
                              st_mode=st_mode)


def interleave_paired_frames(fr1, fr2, valid1, valid2):
    """The paired-end frame interleave (MIBFQuerySupport.hpp:111-130), on
    the frames' device with no host sync. The reference alternates the two
    reads' iterators while both yield and then drains the survivor; over
    valid-frame ordinals that is a closed form: with n1 / n2 valid frames
    and m = min(n1, n2), slot k takes read 1 iff (k < 2m and k even) or
    (k >= 2m and n1 >= n2), at the read's valid ordinal k // 2 (both
    alive) or k - m (drain).

    fr1 / fr2: (raw [R, W, h], hit [R, W, h], usable [R, W], misses [R,
    W]) of each read; valid1 / valid2 bool [R, W] mark yielded frames.
    Returns (raw, hit, usable, misses, live) with W1 + W2 slots a pair,
    dead slots unusable; ``live`` marks slots that carry a yielded frame
    (the nt path's evalCount bumps)."""
    raw1, hit1, u1, mi1 = fr1
    raw2, hit2, u2, mi2 = fr2
    v1 = torch.as_tensor(valid1).to(raw1.device)
    v2 = torch.as_tensor(valid2).to(raw1.device)
    R, W1 = v1.shape
    W2 = v2.shape[1]
    n1 = v1.sum(dim=1, dtype=torch.int64)[:, None]
    n2 = v2.sum(dim=1, dtype=torch.int64)[:, None]
    mmin = torch.minimum(n1, n2)
    k = torch.arange(W1 + W2, device=v1.device)[None, :]
    both = k < 2 * mmin
    from1 = torch.where(both, k % 2 == 0, n1 >= n2)
    ordinal = torch.where(both, k // 2, k - mmin)
    live = k < n1 + n2

    def index(v, W):
        # the j-th valid frame's index: a stable sort puts them first
        order = torch.sort((~v).to(torch.uint8), dim=1, stable=True)[1]
        return order.gather(1, ordinal.clamp(0, W - 1))

    i1, i2 = index(v1, W1), index(v2, W2)

    def pick(a1, a2):
        if a1.dim() == 3:
            x1 = a1.gather(1, i1[..., None].expand(-1, -1, a1.shape[2]))
            x2 = a2.gather(1, i2[..., None].expand(-1, -1, a2.shape[2]))
            return torch.where(from1[..., None], x1, x2)
        return torch.where(from1, a1.gather(1, i1), a2.gather(1, i2))

    usable = pick(u1, u2) & live
    misses = torch.where(live, pick(mi1, mi2), 0).to(mi1.dtype)
    return pick(raw1, raw2), pick(hit1, hit2), usable, misses, live


def query_paired_device_batch(m: MIBloomFilter, hashes1: torch.Tensor,
                              valid1, hashes2: torch.Tensor, valid2,
                              min_count, max_miss: int, num_ids: int,
                              extra_frame_limit: int, st_mode: bool = False):
    """R read pairs, hashes int64 [R, W1, h] / [R, W2, h] -> the engine's
    tables over each pair's interleaved frames: both ends' lookups, the
    interleave and :func:`query_frames_batch`, on the filter's device."""
    fr1 = prep_frames(m, hashes1, valid1, max_miss)
    fr2 = prep_frames(m, hashes2, valid2, max_miss)
    raw, hit, usable, misses, live = interleave_paired_frames(
        fr1, fr2, valid1, valid2)
    return query_frames_batch(m, raw, hit, usable, misses, min_count,
                              num_ids, extra_frame_limit,
                              frame_eval=None if st_mode else live,
                              st_mode=st_mode)


def query_frames_batch(m: MIBloomFilter, frame_raw, frame_hit, frame_valid,
                       frame_misses, min_count, num_ids: int,
                       extra_frame_limit: int, frame_eval=None,
                       st_mode: bool = False):
    """The engine over a batch of reads' frame tables.

    frame_raw    [R, W, h]  data[rank] values (0 where not hit) with the
                            saturation / strand bits, unsigned
    frame_hit    bool [R, W, h]
    frame_valid  bool [R, W]   frame enters the engine
    frame_misses int  [R, W]
    min_count    int  [num_ids] per-ID promotion threshold
    frame_eval   bool [R, W]   frames bumping evalCount once (default: the
                               valid frames; none in ``st_mode``)

    Returns {"counts": int32 [R, num_ids, 6], "candidates": bool [R,
    num_ids], "best": int32 [R, 6], "sat_count": int32 [R], "eval_count":
    int32 [R]}, equal to the reference's sequential engine."""
    _require_narrow(m)
    dev = m.device
    raw = torch.as_tensor(frame_raw).to(dev).to(torch.int64)
    hit = torch.as_tensor(frame_hit).to(dev)
    valid = torch.as_tensor(frame_valid).to(dev)
    misses = torch.as_tensor(frame_misses).to(dev)
    min_count = torch.as_tensor(min_count).to(dev).to(torch.int32)
    if frame_eval is None:
        frame_eval = torch.zeros_like(valid) if st_mode else valid
    frame_eval = torch.as_tensor(frame_eval).to(dev)
    R, W, h = raw.shape
    smask, anti = m.s_mask, m.s_anti_mask

    # --- pass A: per-slot flags -------------------------------------------
    sat = raw > smask
    stripped = torch.where(sat, raw & anti, raw)
    # the ID as the reference's int32 view of it (2**31 wraps negative)
    sid = torch.where(stripped >= (1 << 31), stripped - (1 << 32), stripped)
    earlier = torch.ones((h, h), dtype=torch.bool, device=dev).tril(-1)
    same_raw_earlier = ((raw[..., None, :] == raw[..., :, None]) & earlier
                        & hit[..., None, :])
    first_raw = hit & ~same_raw_earlier.any(dim=-1)
    raw_eq_stripped = raw[..., None, :] == stripped[..., :, None]   # [i, j]
    earlier_pushed = (first_raw[..., None, :] & raw_eq_stripped
                      & earlier).any(dim=-1)
    inc_count_sat = first_raw & sat & ~earlier_pushed
    inc_count_nonsat = first_raw & ~sat
    frame_has_sat = (hit & sat).any(dim=-1)                         # [R, W]
    no_sat = ~frame_has_sat[..., None]
    v3 = valid[..., None]
    in_range = (sid >= 0) & (sid < num_ids)
    contrib = torch.stack([
        (inc_count_sat | inc_count_nonsat) & v3,            # COUNT
        inc_count_nonsat & v3,                              # NONSAT
        hit & v3,                                           # TOTAL
        hit & ~sat & v3,                                    # TOTALNONSAT
        first_raw & v3 & no_sat,                            # NONSATFRAME
        first_raw & v3 & no_sat & (misses[..., None] == 0),  # SOLID
    ], dim=-1) & in_range[..., None]
    contrib = contrib.to(torch.int32)                       # [R, W, h, 6]
    other = ~torch.eye(h, dtype=torch.bool, device=dev)
    stripped_also_seen = (first_raw[..., None, :] & raw_eq_stripped & other
                          & sat[..., :, None] & ~sat[..., None, :]
                          ).any(dim=-1)
    consider = first_raw & v3 & ~(sat & stripped_also_seen)
    # out-of-range IDs add nothing but read the clipped ID's counts
    cid = sid.clamp(0, num_ids - 1)

    # --- pass B: each slot's count of its ID after its frame --------------
    n = W * h
    key, perm = torch.sort(cid.reshape(R, n) * n
                           + torch.arange(n, device=dev), dim=-1)
    cid_s, t_s = key // n, (key % n) // h
    c_s = contrib.reshape(R, n, 6).gather(1, perm[..., None].expand(R, n, 6))
    cs = torch.cumsum(c_s, dim=1)                      # inclusive, int64
    seg_start = torch.searchsorted(key, cid_s * n)
    frame_end = torch.searchsorted(key, cid_s * n + (t_s + 1) * h) - 1
    run = (cs.gather(1, frame_end[..., None].expand(R, n, 6))
           - (cs - c_s).gather(1, seg_start[..., None].expand(R, n, 6)))
    c6 = torch.empty_like(run).scatter_(1, perm[..., None].expand(R, n, 6),
                                        run).reshape(R, W, h, 6)
    mc_slot = min_count[cid]

    # --- pass C: the sequential per-read state ----------------------------
    ok_slots, active, best, satc, evalc = mibf_frame_scan.frame_scan(
        c6.to(torch.int32), consider, mc_slot, valid, frame_has_sat,
        frame_eval, hit.sum(dim=-1, dtype=torch.int32), extra_frame_limit)

    # --- dense tables: counts at each read's stop frame, candidates -------
    t_idx = torch.arange(W, device=dev)
    stop = torch.where(active, t_idx, -1).amax(dim=-1)           # [R]
    elig = (t_idx[None, :] <= stop[:, None])[..., None]           # [R, W, 1]
    flat = (torch.arange(R, device=dev)[:, None, None] * num_ids
            + cid).reshape(-1)
    counts = torch.zeros((R * num_ids, 6), dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, (contrib * elig[..., None]).reshape(-1, 6))
    cand = torch.zeros(R * num_ids, dtype=torch.bool, device=dev)
    cand[flat[ok_slots.reshape(-1)]] = True
    return {"counts": counts.view(R, num_ids, 6),
            "candidates": cand.view(R, num_ids), "best": best,
            "sat_count": satc, "eval_count": evalc}


# ---------------------------------------------------------------------------
# host-side summarize (MIBFQuerySupport.hpp:555-596)
# ---------------------------------------------------------------------------

def _sort_key(r: QueryResult):
    return (-r.non_sat_frame_count, -r.count, -r.solid_count,
            -r.non_sat_count, -r.total_non_sat_count, -r.total_count,
            r.frame_prob)


def _is_valid(c: np.ndarray, best: np.ndarray) -> bool:
    """isValid: OR of six stderr comparisons (MIBFQuerySupport.hpp:333-342)."""
    pairs = [(_COUNT, _COUNT), (_TOTALNONSAT, _TOTALNONSAT),
             (_NONSATFRAME, _NONSATFRAME), (_SOLID, _SOLID),
             (_NONSAT, _NONSAT), (_TOTAL, _TOTAL)]
    return any(_compare_std_err_host(float(best[b]), float(c[a]))
               for a, b in pairs)


def _roughly_equal_or_larger(a: QueryResult, b: QueryResult,
                             extra_count: float) -> bool:
    """isRoughlyEqualOrLarger (MIBFQuerySupport.hpp:347-356)."""
    def cmp(x, y):
        sx = math.sqrt(x) * extra_count
        sy = math.sqrt(y) * extra_count
        return (x - sx) <= (y + sy)
    return (cmp(a.count, b.count) and
            cmp(a.total_non_sat_count, b.total_non_sat_count) and
            cmp(a.non_sat_frame_count, b.non_sat_frame_count) and
            cmp(a.solid_count, b.solid_count) and
            cmp(a.non_sat_count, b.non_sat_count) and
            cmp(a.total_count, b.total_count))


def _check_count_agreement(b: QueryResult, a: QueryResult) -> bool:
    """checkCountAgreement (MIBFQuerySupport.hpp:358-364)."""
    return (b.non_sat_frame_count >= a.non_sat_frame_count and
            b.count >= a.count and b.solid_count >= a.solid_count and
            b.non_sat_count >= a.non_sat_count and
            b.total_non_sat_count >= a.total_non_sat_count and
            b.total_count >= a.total_count)


def summarize(counts: np.ndarray, candidates: np.ndarray, best: np.ndarray,
              per_frame_prob: Sequence[float], min_count: int,
              extra_count: float, best_hit_agree: bool) -> List[QueryResult]:
    """Candidate ranking + equivalence cut + best-hit-agreement veto."""
    results: List[QueryResult] = []
    cand_ids = np.nonzero(candidates)[0]
    if cand_ids.size == 0 or min_count > best[_NONSATFRAME]:
        return results
    signif = []
    for cid in cand_ids:
        c = counts[cid]
        if _is_valid(c, best):
            signif.append(QueryResult(
                id=int(cid), count=int(c[_COUNT]),
                non_sat_count=int(c[_NONSAT]), total_count=int(c[_TOTAL]),
                total_non_sat_count=int(c[_TOTALNONSAT]),
                non_sat_frame_count=int(c[_NONSATFRAME]),
                solid_count=int(c[_SOLID]),
                frame_prob=float(per_frame_prob[cid])))
    if len(signif) > 1:
        signif.sort(key=_sort_key)
        for cand in signif:
            if _roughly_equal_or_larger(signif[0], cand, extra_count):
                results.append(cand)
        if best_hit_agree and len(results) >= 2 and \
                not _check_count_agreement(results[0], results[1]):
            results = []
    elif signif:
        results.append(signif[0])
    return results


# ---------------------------------------------------------------------------
# high-level per-read query
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MIBFQuerySupport:
    """Query engine with the reference's constructor parameters
    (MIBFQuerySupport.hpp:33-59); runs on the filter's device."""

    m: MIBloomFilter
    per_frame_prob: Sequence[float]
    extra_count: float
    extra_frame_limit: int
    max_miss: int
    min_count: int
    best_hit_agree: bool
    sat_count: int = 0
    eval_count: int = 0

    def query(self, hashes: torch.Tensor, valid,
              min_count_vec) -> List[QueryResult]:
        """Single-read query (MIBFQuerySupport.hpp:94-109): hashes int64
        [W, h]; valid marks iterator-yielded frames."""
        return self.query_many(hashes[None], torch.as_tensor(valid)[None],
                               min_count_vec)[0]

    def query_many(self, hashes: torch.Tensor, valid,
                   min_count_vec) -> List[List[QueryResult]]:
        """Batched query: hashes int64 [R, W, h], valid bool [R, W]; one
        result list per read. ``sat_count`` and ``eval_count`` become the
        batch's totals."""
        return self._summarize(query_device_batch(
            self.m, hashes, valid, min_count_vec, self.max_miss,
            len(self.per_frame_prob), self.extra_frame_limit,
            st_mode=bool(self.m.sseeds)))

    def query_paired(self, hashes1: torch.Tensor, valid1,
                     hashes2: torch.Tensor, valid2,
                     min_count_vec) -> List[QueryResult]:
        """Paired-end query (MIBFQuerySupport.hpp:111-130): the two reads'
        frames interleaved, then whichever read still has frames."""
        return self.query_paired_many(
            hashes1[None], torch.as_tensor(valid1)[None], hashes2[None],
            torch.as_tensor(valid2)[None], min_count_vec)[0]

    def query_paired_many(self, hashes1: torch.Tensor, valid1,
                          hashes2: torch.Tensor, valid2,
                          min_count_vec) -> List[List[QueryResult]]:
        """Batched paired-end query: hashes int64 [R, W1, h] and [R, W2,
        h], valid bool [R, W1] and [R, W2]; one result list per pair."""
        return self._summarize(query_paired_device_batch(
            self.m, hashes1, valid1, hashes2, valid2, min_count_vec,
            self.max_miss, len(self.per_frame_prob), self.extra_frame_limit,
            st_mode=bool(self.m.sseeds)))

    def _summarize(self, out) -> List[List[QueryResult]]:
        """The engine's tables of a batch -> one ranked result list a read
        (or pair), on the host; the batch's sat and eval counts."""
        out = {k: v.cpu().numpy() for k, v in out.items()}
        self.sat_count = int(out["sat_count"].sum())
        self.eval_count = int(out["eval_count"].sum())
        return [summarize(out["counts"][r], out["candidates"][r],
                          out["best"][r], self.per_frame_prob,
                          self.min_count, self.extra_count,
                          self.best_hit_agree)
                for r in range(out["best"].shape[0])]

    def get_match_signature(self, hashes: torch.Tensor, valid):
        """getMatchSignature (MIBFQuerySupport.hpp:158-217) of one read's
        frames hashes int64 [W, h]: (match_pos int64 [n_match] numpy, the
        evaluated frames' count, ids uint32 [n_match, h], sat bool [n_match,
        h]), matches in window order. A frame matches when its misses are
        within ``max_miss`` on a spaced-seed filter and when every slot
        hits otherwise; a slot gives (value & s_anti_mask, saturated) where
        it hits and (0, False) where it misses."""
        _require_narrow(self.m)
        _, hit, raw = mibf_mod.at_rank_data(self.m, hashes)
        v = torch.as_tensor(valid).to(self.m.device)
        misses = (~hit).sum(dim=-1)
        match = v & (misses <= (self.max_miss if self.m.sseeds else 0))
        ids = torch.where(hit, raw & self.m.s_anti_mask, 0)
        sat = hit & (raw > self.m.s_mask)
        match_pos = torch.nonzero(match).reshape(-1)
        return (match_pos.cpu().numpy(), int(v.sum()),
                ids[match_pos].cpu().numpy().astype(np.uint32),
                sat[match_pos].cpu().numpy())
