"""MIBF construction: the 4-phase pipeline of MIBFConstructSupport, as torch
tensors.

Semantics are the reference's ``models/mibf_construct.py``:

Phase 1  populate a plain bit vector from hash frames      (insertBV)
Phase 2  freeze into an MIBF with rank structure           (getEmptyMIBF)
Phase 3  per-ID reservoir-sampled ID insertion             (insertMIBF)
Phase 4  saturation pass with ID-mutation rescue           (setSatIfMissing)

Phase 3 processes each sequence's unique hash values in ascending unsigned
order (the reference's documented order), with the order-exact reservoir
arithmetic; phase 4 equals processing the frames one at a time in stream
order, including the reference's pre-filled-zeros quirk (ID 0 always
counts as duplicated).

Phase 1 goes through the scatter-OR kernel (``kernels/scatter_or``), the
rank lookups of phases 3 and 4 through the MIBF rank kernel
(``kernels/mibf_rank``) when the state lies on a GPU; the rest is torch.
``insert_bv_colli`` is phase 1 counting the frames whose bits were all set
already (insertBVColli), ``insert_bv_colli_sequential`` its per-frame
mirror.

Every width takes every phase. At width 8 (uint64 IDs) the reservoir takes
the full 64-bit ``(v ^ id) % count`` where narrower widths take the low
limb, the occurrence counters stay uint32 (``count_width``), and phase 4 is
the same batched decomposition, where the reference runs its per-frame
mirror; the random-order insert runs only in the host mirror, as in the
reference.

Beside the four phases, MIBloomFilter::insert, the single-pass,
random-order, strand-carrying insert: ``insert_random_order``, the host
mirror, and ``insert_random_order_device``, the same result from the
``kernels/mibf_random_insert`` kernel on a GPU (parallel rounds of frames
that share no ID entry, then an in-order tail).
Unlike the reference, whose functions return new arrays, every phase
updates the bit vector, ``m.data`` and ``counts`` in place (and returns
them).

Three things differ from the reference's decomposition, none in result:
hashes are int64 bit patterns, so the unsigned sort flips the sign bit of
its key; the segment scans (group starts and ends, "last accepted") are
segment arithmetic (``nonzero``, ``cumsum``, ``scatter_reduce``); and phase
4's entangled replay runs its round schedule to the fixpoint with no round
cap, so the per-frame fallback of the reference's scheduler is never
needed. Past ``max_entangled`` the whole batch replays in those rounds from
the state before it, where the reference scans frame by frame.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..kernels import mibf_random_insert, scatter_or
from ..ops import u64
from ..ops.replay import replay_depth
from ..utils import stdcpp
from . import bloom as bloom_mod
from . import mibf as mibf_mod
from .mibf import MIBloomFilter

_SIGN = -(1 << 63)            # flips uint64 order into int64 order
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class BitVectorState:
    """Phase-1 state: the raw bit vector being populated."""

    bv_words: torch.Tensor    # int32 [ceil(filter_size / 32)], uint32 bits
    filter_size: int
    kmer_size: int
    hash_num: int
    occupancy: float
    sseeds: tuple


def create(expected_entries: int, k: int, hash_num: int,
           occupancy: float = 0.5, spaced_seeds: Sequence[str] = (), *,
           device="cuda") -> BitVectorState:
    """MIBFConstructSupport ctor (MIBFConstructSupport.hpp:36-46): an empty
    bit vector sized for ``expected_entries`` at ``occupancy``, on
    ``device``."""
    size = mibf_mod.calc_optimal_size(expected_entries, hash_num, occupancy)
    return BitVectorState(
        bv_words=torch.zeros((size + 31) // 32, dtype=torch.int32,
                             device=device),
        filter_size=size, kmer_size=k, hash_num=hash_num,
        occupancy=occupancy, sseeds=tuple(spaced_seeds))


def _ids(ids, device) -> torch.Tensor:
    """Sequence IDs (a tensor, list, range or array) as int64 on device."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(np.asarray(ids, dtype=np.int64))
    return ids.to(device).to(torch.int64)


def _valid_mask(valid, shape, device) -> torch.Tensor:
    if valid is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return torch.as_tensor(valid).to(device).broadcast_to(shape)


def _check_size(state: BitVectorState) -> None:
    if state.filter_size > mibf_mod.MAX_SIZE:
        raise ValueError(f"bit vector of {state.filter_size} bits: at most "
                         "2**32")


def insert_bv(state: BitVectorState, hashes: torch.Tensor,
              valid=None) -> BitVectorState:
    """Phase 1: set the bit of every frame position (insertBV,
    MIBFConstructSupport.hpp:75-87). hashes int64 [..., h]; ``valid`` masks
    frames. Positions take the Bloom filter's form
    (``bloom.position_dtype``): at exactly 2**32 bits the wide one, whose
    sentinel -1 leaves 0xFFFFFFFF a real position (the JAX package's phase
    1 drops bit 2**32 - 1 as its sentinel). Updates ``state.bv_words`` in
    place."""
    dev = state.bv_words.device
    _check_size(state)
    pos = bloom_mod.hash_positions(hashes.to(dev), state.filter_size)
    v = _valid_mask(valid, hashes.shape[:-1], dev)[..., None]
    scatter_or.scatter_or(state.bv_words, torch.where(v, pos, -1))
    return state


def insert_bv_colli(state: BitVectorState, hashes: torch.Tensor,
                    valid=None):
    """Phase 1 that also counts the valid frames whose h bits were all set
    at their turn (insertBVColli, MIBFConstructSupport.hpp:55-73): set
    before the batch or by a valid frame before it, a frame's own writes
    not counting. That is the order-exact insertAndCheck, so the closed
    form is ``bloom.insert_and_check_sequential``'s (the first frame to
    write each position, over a sort of the positions). Updates
    ``state.bv_words`` in place; returns (state, count)."""
    _check_size(state)
    bf = bloom_mod.BloomFilter(words=state.bv_words, size=state.filter_size,
                               hash_num=state.hash_num,
                               kmer_size=state.kmer_size)
    _, found = bloom_mod.insert_and_check_sequential(bf, hashes, valid)
    return state, int(found.sum())


def insert_bv_colli_sequential(state: BitVectorState, hashes: torch.Tensor,
                               valid=None):
    """insertBVColli one frame at a time on the host: the transparent
    mirror :func:`insert_bv_colli` is held against. Updates
    ``state.bv_words`` in place; returns (state, count)."""
    _check_size(state)
    h = hashes.shape[-1]
    pos = u64.to_numpy(u64.mod_const(hashes, state.filter_size)).reshape(
        -1, h)
    v = _valid_mask(valid, hashes.shape[:-1], "cpu").reshape(-1).numpy()
    words = state.bv_words.cpu().numpy().view(np.uint32).copy()
    count = 0
    for p in pos[v]:
        w, b = p >> np.uint64(5), (p & np.uint64(31)).astype(np.uint32)
        count += bool(((words[w] >> b) & 1).all())
        np.bitwise_or.at(words, w, np.uint32(1) << b)
    state.bv_words.copy_(torch.from_numpy(words.view(np.int32)))
    return state, count


def count_width(data_width: int) -> int:
    """Bytes of an occurrence counter: the data's width, but 4 at width 8,
    where the reference's counters are uint32 and wrap at 2**32."""
    return min(data_width, 4)


def get_empty_mibf(state: BitVectorState, data_width: int = 2):
    """Phase 2: freeze the bit vector into an MIBF + zeroed occurrence
    counters in the storage dtype of ``count_width`` (getEmptyMIBF,
    MIBFConstructSupport.hpp:92-99)."""
    m = mibf_mod.freeze(state.bv_words, state.filter_size, state.hash_num,
                        state.kmer_size, data_width=data_width,
                        sseeds=state.sseeds)
    return m, torch.zeros(m.d_size, device=m.device,
                          dtype=mibf_mod.STORAGE[count_width(data_width)])


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def _segments(sorted_keys: torch.Tensor):
    """Runs of equal values in a sorted 1-D tensor: (gid [n] run index of
    each element, starts [runs] first index of each run)."""
    new = torch.ones(sorted_keys.shape, dtype=torch.bool,
                     device=sorted_keys.device)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return torch.cumsum(new, 0) - 1, torch.nonzero(new).reshape(-1)


def reservoir_core(data: torch.Tensor, counts: torch.Tensor,
                   rank: torch.Tensor, values: torch.Tensor,
                   keep: torch.Tensor, ids: torch.Tensor, d_size: int,
                   data_width: int):
    """The order-exact reservoir arithmetic of insertMIBF
    (MIBFConstructSupport.hpp:120-129): for the hash values int64 [n]
    (uint64 bits, each sequence's unique values in ascending order,
    sequences in ID order) with their ranks and IDs int64 [n], where ``keep``
    marks the values that take part:

        count = ++counts[rank]; accept iff (v ^ id) % count == count - 1
        (std::hash<T> is the identity after truncation to T: widths 1 / 2 /
        4 take the low limb, width 8 the full 64 bits)

    and the last acceptance of each rank writes its ID, keeping the entry's
    saturation bit. ``data`` and ``counts`` (in the storage dtype of
    ``count_width``) are updated in place; counts wrap at their width."""
    n = rank.numel()
    if n == 0 or d_size == 0:
        return data, counts
    if n >= (1 << 32):
        raise ValueError(f"{n} hash values in one batch; the (rank, index) "
                         "key holds at most 2**32 - 1")
    dev = rank.device
    bits = 8 * data_width
    wmask = u64.as_signed((1 << bits) - 1)
    smask = u64.as_signed(1 << (bits - 1))
    cwidth = count_width(data_width)
    cmask = (1 << (8 * cwidth)) - 1
    idx = torch.arange(n, device=dev)
    rank = torch.where(keep, rank.to(torch.int64), d_size)
    # stable order by rank: (rank, index) as one int64 key
    key = torch.sort((rank << 32) | idx)[0]
    rank_o, perm = key >> 32, key & _MASK32
    keep_o = keep[perm]
    gid, starts = _segments(rank_o)
    within = idx - starts[gid]
    c0 = torch.where(keep_o, u64.unsigned(
        counts[rank_o.clamp(0, max(d_size - 1, 0))]), 0)
    count_val = (c0 + within + 1) & cmask
    if data_width == 8:
        hmod = u64.mod_u32(values[perm] ^ ids[perm], count_val.clamp(min=1))
    else:
        hval = (values[perm] ^ (ids[perm] & _MASK32)) & _MASK32 & wmask
        hmod = hval % count_val.clamp(min=1)
    accepted = keep_o & (count_val != 0) & (hmod == count_val - 1)
    # the last accepted element of each rank group wins; a value whose
    # position misses past the last set bit (rank d_size) writes nothing
    last = torch.full((starts.numel(),), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, gid[accepted], idx[accepted], "amax")
    winner = accepted & (idx == last[gid]) & (rank_o < d_size)
    wr = rank_o[winner]
    wid = ids[perm][winner] & wmask
    data[wr] = mibf_mod.to_storage(wid | (u64.unsigned(data[wr]) & smask),
                                   data_width)
    # counts[rank] += group size (wrapping at the counters' width)
    run_len = torch.diff(starts, append=starts.new_tensor([n]))
    g_rank = rank_o[starts]
    live = g_rank < d_size
    r = g_rank[live]
    counts[r] = mibf_mod.to_storage(
        (u64.unsigned(counts[r]) + run_len[live]) & cmask, cwidth)
    return data, counts


def insert_mibf_many(m: MIBloomFilter, counts: torch.Tensor,
                     hashes: torch.Tensor, ids, valid=None):
    """Phase 3 for a batch of sequences: hashes int64 [G, W, h] with IDs
    [G] (stream order = ascending G) and valid bool [G, W]. Equal to calling
    :func:`insert_mibf` per sequence in order: each sequence's unique
    values in ascending unsigned order, one rank lookup and one reservoir
    pass over the concatenated stream. Updates in place; returns
    (m, counts)."""
    dev = m.device
    G = hashes.shape[0]
    h2 = hashes.to(dev).reshape(G, -1)
    v = _valid_mask(valid, hashes.shape[:-1], dev)[..., None]
    v = v.broadcast_to(hashes.shape).reshape(G, -1)
    # unsigned ascending order with the all-ones sentinel last: sort the
    # bits with the sign flipped
    key = torch.sort(torch.where(v, h2, -1) ^ _SIGN, dim=-1)[0]
    vals = key ^ _SIGN
    keep = torch.ones_like(v)
    keep[:, 1:] = key[:, 1:] != key[:, :-1]
    # a genuine hash of 2**64-1 would collide with the sentinel; as in the
    # reference it is dropped
    keep &= vals != -1
    idvec = _ids(ids, dev).repeat_interleave(vals.shape[1])
    vals, keep = vals.reshape(-1), keep.reshape(-1)
    rank, _ = mibf_mod.rank_of_positions(m, mibf_mod.positions(m, vals))
    reservoir_core(m.data, counts, rank, vals, keep, idvec, m.d_size,
                   m.data_width)
    return m, counts


def insert_mibf(m: MIBloomFilter, counts: torch.Tensor, hashes: torch.Tensor,
                id_value: int, valid=None):
    """Phase 3 for one sequence (insertMIBF, MIBFConstructSupport.hpp:
    109-130): reservoir sampling of ``id_value`` over the unique hash values
    of hashes int64 [..., h] in ascending order. Updates in place; returns
    (m, counts)."""
    h = hashes.shape[-1]
    v = None if valid is None else _valid_mask(
        valid, hashes.shape[:-1], m.device).reshape(1, -1)
    return insert_mibf_many(m, counts, hashes.reshape(1, -1, h), [id_value],
                            v)


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def _phase4_ranks(m: MIBloomFilter, hashes: torch.Tensor, valid):
    """Per-frame rank rows int64 [n, h] and valid [n] of hashes [..., h]."""
    h = hashes.shape[-1]
    rank, _ = mibf_mod.rank_of_positions(m, mibf_mod.positions(m, hashes))
    v = _valid_mask(valid, hashes.shape[:-1], m.device).reshape(-1)
    return rank.reshape(-1, h).to(torch.int64), v


def _phase4_apply(data: torch.Tensor, counts: torch.Tensor,
                  rk: torch.Tensor, ids: torch.Tensor, d_size: int,
                  data_width: int) -> None:
    """One setSatIfMissing step (MIBFConstructSupport.hpp:168-214) for every
    row of rk int64 [g, h] with IDs int64 [g] at once, in place; the rows
    must touch pairwise-disjoint ranks. For each frame: if no slot holds the
    ID, the slot of largest count among those whose ID is duplicated in the
    frame (or 0) takes the ID (its count + 1); if there is none, every slot
    saturates."""
    if rk.shape[0] == 0:
        return
    h = rk.shape[1]
    bits = 8 * data_width
    wmask = u64.as_signed((1 << bits) - 1)
    smask = 1 << (bits - 1)
    cwidth = count_width(data_width)
    cmask = (1 << (8 * cwidth)) - 1
    safe = rk.clamp(0, max(d_size - 1, 0))
    results = u64.unsigned(data[safe])                    # [g, h]
    cur = results & (smask - 1)
    idv = ids & wmask
    found = (cur == idv[:, None]).any(dim=1)
    # seenSet and replacementIDs start as h zeros: 0 is always duplicated
    earlier = torch.ones((h, h), dtype=torch.bool,
                         device=rk.device).tril(-1)       # [i, j]: j < i
    eq = cur[:, :, None] == cur[:, None, :]
    in_seen = (cur == 0) | (eq & earlier).any(dim=-1)
    in_repl = (cur == 0) | (eq & in_seen[:, None, :]).any(dim=-1)
    slot_counts = u64.unsigned(counts[safe])
    score = torch.where(in_repl & (slot_counts > 0), slot_counts, 0)
    best = score.amax(dim=1)
    # first slot achieving the maximum
    slots = torch.arange(h, device=rk.device)
    first = torch.where(score == best[:, None], slots, h).amin(dim=1)
    repl = safe.gather(1, first[:, None])[:, 0]
    old = results.gather(1, first[:, None])[:, 0]
    mutate = ~found & (best > 0)
    sat = ~found & (best == 0)
    mr = repl[mutate]
    sbit = u64.as_signed(smask)
    new_id = torch.where(u64.gt_const(old, smask), idv | sbit, idv)[mutate]
    data[mr] = mibf_mod.to_storage(new_id, data_width)
    counts[mr] = mibf_mod.to_storage(
        (u64.unsigned(counts[mr]) + 1) & cmask, cwidth)
    data[safe[sat].reshape(-1)] = mibf_mod.to_storage(
        (results[sat] | sbit).reshape(-1), data_width)


def _replay(data, counts, rk: torch.Tensor, ids: torch.Tensor, d_size: int,
            data_width: int) -> None:
    """Apply frames rk int64 [m, h] (stream order) with IDs [m] exactly as
    stream order would: in rounds of rank-disjoint frames
    (``ops.replay.replay_depth``). A slot at the rank sentinel d_size orders
    nothing, as in the reference's schedule: it takes a value of its own
    above d_size, so those values must stay below 2**32."""
    m, h = rk.shape
    if m == 0:
        return
    if d_size + 1 + m * h > (1 << 32):
        raise ValueError(f"{m} frames of {h} slots over {d_size} ranks; the "
                         "replay keys need d_size + 1 + slots <= 2**32")
    p = rk.T.contiguous()
    unique = d_size + 1 + torch.arange(m * h, device=rk.device).view(h, m)
    depth = replay_depth(torch.where(p == d_size, unique, p))
    order = torch.argsort(depth, stable=True)
    start = 0
    for n_round in torch.bincount(depth)[1:].tolist():
        rows = order[start:start + n_round]
        _phase4_apply(data, counts, rk[rows], ids[rows], d_size, data_width)
        start += n_round


def saturation_ranks_many(data: torch.Tensor, counts: torch.Tensor,
                          rk: torch.Tensor, v: torch.Tensor,
                          ids: torch.Tensor, d_size: int, data_width: int,
                          max_entangled=None, domain_size=None) -> None:
    """Phase 4 over frames rk int64 [n, h] (ranks) with per-frame IDs [n]
    and valid [n], equal to stream order; ``data`` and ``counts`` are
    updated in place.

    Frames with the same (rank tuple, ID) form a group; only a group's
    first frame acts (a mutate makes the ID present for the next, a
    saturate is idempotent). Groups that share no rank with another group
    apply at once; the frames of the other ("entangled") groups replay in
    stream order by rounds. When more frames are entangled than
    ``max_entangled`` (default: twice the expected number of shared ranks
    in the position domain ``domain_size``, plus 64), the whole batch
    replays by rounds instead."""
    n, h = rk.shape
    if n == 0 or d_size == 0:
        return
    if n * h >= (1 << 32):
        raise ValueError(f"{n} frames of {h} slots in one batch; at most "
                         "2**32 - 1 slots")
    dev = rk.device
    ids = ids.to(torch.int64)
    rk = torch.where(v[:, None], rk, d_size)

    # --- group by (rank tuple, id): stable sorts, least significant first;
    # two 31-bit ranks share one key
    cols = [rk[:, j] for j in range(h)]
    keys = [(cols[j] << 31) | cols[j + 1] for j in range(0, h - 1, 2)]
    if h % 2:
        keys.append(cols[-1])
    perm = torch.sort(ids, stable=True)[1]
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True)[1]]
    ks = rk[perm]
    new_grp = torch.ones(n, dtype=torch.bool, device=dev)
    new_grp[1:] = (ks[1:] != ks[:-1]).any(dim=1) | (ids[perm][1:]
                                                    != ids[perm][:-1])
    gid = torch.cumsum(new_grp, 0) - 1
    n_groups = int(gid[-1]) + 1

    # --- entanglement: ranks shared across groups (sentinel excluded) -----
    pair = torch.sort((ks.reshape(-1) << 32)
                      | torch.arange(n * h, device=dev))[0]
    pr_s, pi_s = pair >> 32, pair & _MASK32
    pg_s = gid.repeat_interleave(h)[pi_s]
    shared_prev = torch.zeros(n * h, dtype=torch.bool, device=dev)
    shared_prev[1:] = ((pr_s[1:] == pr_s[:-1]) & (pg_s[1:] != pg_s[:-1])
                       & (pr_s[1:] != d_size))
    shared = shared_prev.clone()
    shared[:-1] |= shared_prev[1:]
    flags = torch.empty(n * h, dtype=torch.bool, device=dev)
    flags[pi_s] = shared
    frame_shared = flags.view(n, h).any(dim=1)
    entangled = torch.zeros(n_groups, dtype=torch.int64, device=dev
                            ).index_add_(0, gid, frame_shared.to(torch.int64)
                                         )[gid] > 0
    live = ks[:, 0] != d_size
    entangled &= live
    rep = new_grp & live & ~entangled

    if max_entangled is not None:
        cap = max_entangled
    else:
        # collisions live in the hash-position domain (the bit vector)
        dom = domain_size if domain_size is not None else d_size
        expected = (n * h) ** 2 // (2 * max(dom, 1))
        cap = max(64, 2 * expected + 64)
    cap = min(cap, n)
    ent = torch.sort(perm[entangled])[0]
    if ent.numel() > cap:
        # too many frames for the replay buffer: the whole batch, from the
        # state before it
        valid_rows = torch.nonzero(v).reshape(-1)
        _replay(data, counts, rk[valid_rows], ids[valid_rows], d_size,
                data_width)
        return
    rows = perm[rep]
    _phase4_apply(data, counts, rk[rows], ids[rows], d_size, data_width)
    _replay(data, counts, rk[ent], ids[ent], d_size, data_width)


def insert_saturation_many(m: MIBloomFilter, counts: torch.Tensor,
                           hashes: torch.Tensor, ids, valid=None,
                           max_entangled=None):
    """Phase 4 for a batch of sequences: hashes int64 [G, W, h], IDs [G],
    valid bool [G, W]; stream order = ascending (G, W). Equal to
    :func:`insert_saturation` per sequence in ID order. Updates in place;
    returns (m, counts)."""
    W = hashes.shape[1]
    rk, v = _phase4_ranks(m, hashes, valid)
    idvec = _ids(ids, m.device).repeat_interleave(W)
    saturation_ranks_many(m.data, counts, rk, v, idvec, m.d_size,
                          m.data_width, max_entangled, domain_size=m.size)
    return m, counts


def insert_saturation_sequential(m: MIBloomFilter, counts: torch.Tensor,
                                 hashes: torch.Tensor, id_value: int,
                                 valid=None):
    """Phase 4 one frame at a time in stream order: the transparent mirror
    of setSatIfMissing (MIBFConstructSupport.hpp:168-214). Updates in
    place; returns (m, counts)."""
    rk, v = _phase4_ranks(m, hashes, valid)
    idv = torch.full((1,), int(id_value), dtype=torch.int64, device=m.device)
    for f in torch.nonzero(v).reshape(-1).tolist():
        _phase4_apply(m.data, counts, rk[f:f + 1], idv, m.d_size,
                      m.data_width)
    return m, counts


def insert_saturation(m: MIBloomFilter, counts: torch.Tensor,
                      hashes: torch.Tensor, id_value: int, valid=None,
                      max_entangled=None):
    """Phase 4 for one sequence (setSatIfMissing,
    MIBFConstructSupport.hpp:168-214), batched and equal to stream order.
    Updates in place; returns (m, counts)."""
    rk, v = _phase4_ranks(m, hashes, valid)
    if rk.shape[0] <= 2:
        return insert_saturation_sequential(m, counts, hashes, id_value,
                                            valid)
    ids = torch.full((rk.shape[0],), int(id_value), dtype=torch.int64,
                     device=m.device)
    saturation_ranks_many(m.data, counts, rk, v, ids, m.d_size,
                          m.data_width, max_entangled, domain_size=m.size)
    return m, counts


# ---------------------------------------------------------------------------
# MIBloomFilter::insert: the single-pass random-order insert
# ---------------------------------------------------------------------------

def insert_random_order(m: MIBloomFilter, hashes, id_value: int,
                        max_count: int, strand=None):
    """The host mirror of MIBloomFilter::insert (MIBloomFilter.hpp:312-438):
    frame by frame, a random-order, non-overwriting insert of ``id_value``
    into the frame's slots, in the order minstd_rand + std::shuffle give
    (``utils/stdcpp``), with the saturation fallback; ``strand`` bool [n,
    h] adds the strand bit where a slot's strand differs from the insert's
    direction. hashes: uint64 [n, h] (numpy) or int64 [n, h] (uint64 bits).
    Walks the filter's arrays on the host and writes the IDs back into
    ``m.data`` in place; returns (m, success bool [n] numpy). A frame that
    places nothing and is not saturated asserts ``max_count == 1``, as the
    reference does. Every width, 8 included."""
    if isinstance(hashes, torch.Tensor):
        hashes = u64.to_numpy(hashes)
    bv_words, cum, _ = mibf_mod.to_numpy(m)
    data = mibf_mod.ids_numpy(m).copy()
    s_mask, s_anti = m.s_mask, m.s_anti_mask
    if strand is not None:
        strand = np.asarray(torch.as_tensor(strand).cpu())

    def rank_of(posv):
        word = posv >> 5
        before = int(bv_words[word]) & ((1 << (posv & 31)) - 1)
        return int(cum[word]) + bin(before).count("1")

    results = []
    strand_dir = bool(max_count % 2)
    for fi, row in enumerate(np.asarray(hashes, dtype=np.uint64)):
        count = 0
        hash_order = []
        saturated = True
        rand_value = id_value
        vals = []
        for i, hv in enumerate(row):
            rk = rank_of(int(hv) % m.size)
            value = id_value
            if strand is not None and strand_dir ^ bool(strand[fi][i]):
                value = id_value | m.s_strand
            vals.append((rk, value))
            old = int(data[rk])
            oldv = old & s_anti if old > s_mask else old
            if old <= s_mask:
                saturated = False
            if oldv == value:
                count += 1
            else:
                hash_order.append(i)
            if count >= max_count:
                results.append(True)
                break
            rand_value ^= int(hv)
        else:
            g = stdcpp.MinstdRand(rand_value)
            inserted = False
            for i in stdcpp.shuffle(hash_order, g):
                rk, value = vals[i]
                old = int(data[rk])
                if old == 0:
                    data[rk] = value
                if old > s_mask:
                    old &= s_anti
                else:
                    saturated = False
                if old == 0:
                    count += 1
                if count >= max_count:
                    results.append(True)
                    inserted = True
                    break
            if not inserted:
                if count == 0:
                    if not saturated:
                        assert max_count == 1, (
                            "spaced seed is probably not symmetric")
                        for rk, _ in vals:
                            data[rk] |= s_mask
                    results.append(False)
                else:
                    results.append(True)
    m.data.copy_(torch.from_numpy(data.view(
        mibf_mod._NP_SIGNED[m.data_width])))
    return m, np.array(results, dtype=bool)


def insert_random_order_device(m: MIBloomFilter, hashes: torch.Tensor,
                               id_value: int, max_count: int, strand=None,
                               valid=None):
    """MIBloomFilter::insert of frames hashes int64 [..., h] on the
    filter's device, bit for bit the host mirror
    :func:`insert_random_order` (the strand-aware overload when ``strand``
    bool [..., h] is given; ``valid`` bool [...] masks frames). On a GPU
    the ``kernels/mibf_random_insert`` kernel runs the frames in parallel
    rounds of frames that share no ID entry, then walks the rest in
    order; on the CPU its plain version walks them all in order. Where the host mirror asserts,
    this saturates. Updates ``m.data`` in place; returns (m, success bool
    [...]). Widths 1, 2 and 4: as in the reference, width 8 runs only in
    the host mirror."""
    if m.data_width == 8:
        raise NotImplementedError(
            "width-8 random-order insert runs only in the host mirror "
            "insert_random_order")
    dev = m.device
    h = hashes.shape[-1]
    lead = hashes.shape[:-1]
    flat = hashes.to(dev).reshape(-1, h)
    st = None if strand is None else \
        torch.as_tensor(strand).to(dev).reshape(-1, h)
    v = None if valid is None else \
        torch.as_tensor(valid).to(dev).broadcast_to(lead).reshape(-1)
    success = mibf_random_insert.random_insert(
        m.bv_words, m.cum_ranks, m.rank_dir, m.data, flat, m.size,
        int(id_value), max_count, st, v)
    return m, success.reshape(lead)
