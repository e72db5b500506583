"""Multi-index Bloom filter (MIBF): rank/select ID lookup, as torch tensors.

Semantics are the reference's ``models/mibf.py`` (MIBloomFilter.hpp): the
frozen bit vector plus its exclusive per-word cumulative popcounts give
rank(p) = #set bits before p in one lookup; the ID array ("data") is indexed
by rank. The top bit of each data value is the saturation flag ``s_mask``,
the next the strand flag ``s_strand``, the rest the ID.

Storage: ``bv_words`` and ``cum_ranks`` are int32 tensors holding uint32
bits; ``data`` holds the IDs at their native width as bit patterns
(widths 1 / 2 / 4 / 8 bytes as uint8 / int16 / int32 / int64), so its bytes
are the reference's ID array; every comparison on it is unsigned
(``ops/u64.unsigned``, ``u64.gt_const``). Width 8 (MIBloomFilter<uint64_t>,
its s_mask and s_strand at bits 63 and 62) is one int64 plane, where the
reference keeps two uint32 planes; ``from_numpy`` / ``to_numpy`` take and
give those planes, and value results come back as int64 holding the
uint64 bits. ``rank_dir`` is derived from the two: the rank
directory of ``kernels/mibf_rank`` (the cumulative count and 7 words a 32
bytes, so a lookup on the card reads one sector), built once by
``freeze``, through which every filter is made; the bit vector never
changes after it.

Rank and ID lookups go through the CUDA kernel ``kernels/mibf_rank`` when
the filter lies on a GPU, through its plain version on the CPU; that one
routine serves the reference's ``rank_of_positions``,
``rank_of_positions_auto`` and both of its ``*_kernel`` chains. Bit vectors
go up to 2**32 bits, as the JAX package's: a lookup's position is uint32
(int32 bits) at every size, exact at 2**32 too, since a lookup takes no
sentinel (the frames' validity travels as a mask of its own).

Unlike the reference, ``saturate`` and ``set_data`` update ``m.data`` in
place and return ``m``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import mibf_rank
from ..ops import u64

# the longest bit vector, in bits, as in the JAX package
MAX_SIZE = 1 << 32

STORAGE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# numpy of STORAGE
_NP_SIGNED = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}


def check_width(data_width: int) -> None:
    if data_width not in STORAGE:
        raise ValueError(f"unsupported data width {data_width}")


def to_storage(values: torch.Tensor, data_width: int) -> torch.Tensor:
    """Unsigned int64 values < 2**(8 * data_width) (at width 8, int64
    holding the uint64 bits) -> the storage dtype with the same bits."""
    if data_width == 1:
        return values.to(torch.uint8)
    if data_width == 2:
        return torch.where(values >= (1 << 15), values - (1 << 16),
                           values).to(torch.int16)
    if data_width == 8:
        return values
    return u64.to_u32_bits(values)


def u64_planes(values: np.ndarray) -> np.ndarray:
    """uint64 IDs [n] -> the JAX package's width-8 state, uint32 [2, n]
    (row 0 the low limbs)."""
    values = np.asarray(values, dtype=np.uint64)
    return np.stack([(values & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (values >> np.uint64(32)).astype(np.uint32)])


@dataclasses.dataclass
class MIBloomFilter:
    bv_words: torch.Tensor    # int32 [ceil(size/32)] frozen bit vector
    cum_ranks: torch.Tensor   # int32 [nwords] exclusive cumulative popcounts
    rank_dir: torch.Tensor    # int32 [8 * ceil(nwords / 7)] rank directory
    data: torch.Tensor        # ID array [d_size], storage dtype of the width
    size: int                 # bit-vector length in bits
    hash_num: int
    kmer_size: int
    d_size: int               # population count == len(data)
    data_width: int           # bytes per ID: 1, 2, 4 or 8
    sseeds: Tuple[str, ...] = ()

    # --- bit-layout constants (MIBloomFilter.hpp:36-44) -------------------
    @property
    def s_mask(self) -> int:
        return 1 << (8 * self.data_width - 1)

    @property
    def s_anti_mask(self) -> int:
        return self.s_mask - 1

    @property
    def s_strand(self) -> int:
        return 1 << (8 * self.data_width - 2)

    @property
    def s_id_mask(self) -> int:
        return self.s_strand - 1

    @property
    def width_mask(self) -> int:
        return (1 << (8 * self.data_width)) - 1

    @property
    def device(self) -> torch.device:
        return self.bv_words.device


def calc_optimal_size(entries: int, hash_num: int, occupancy: float) -> int:
    """Occupancy-based sizing (MIBloomFilter.hpp:84-88)."""
    non64 = int(-float(entries) * hash_num / math.log(1.0 - occupancy))
    return non64 + (64 - non64 % 64)


def calc_prob_single_frame(occupancy: float, hash_num: int, freq: float,
                           allowed_misses: int) -> float:
    """Per-frame random-match probability (MIBloomFilter.hpp:65-77)."""
    total = 0.0
    for i in range(hash_num - allowed_misses, hash_num + 1):
        prob = math.comb(hash_num, i)
        prob *= occupancy ** i
        prob *= (1.0 - occupancy) ** (hash_num - i)
        prob *= 1.0 - (1.0 - freq) ** i
        total += prob
    return total


# ---------------------------------------------------------------------------
# construction from a frozen bit vector
# ---------------------------------------------------------------------------

# words ``freeze`` counts at a time
_FREEZE_CHUNK = 1 << 24


def freeze(bv_words: torch.Tensor, size: int, hash_num: int, kmer_size: int,
           data_width: int = 2, sseeds: Sequence[str] = ()) -> MIBloomFilter:
    """Rank structure and an empty ID array over a populated bit vector
    (int32 words, uint32 bits), on the vector's device; the filter shares
    the words tensor. The MIBloomFilter(bv) constructor
    (MIBloomFilter.hpp:122-147), plus the rank directory the lookups read
    on the card."""
    check_width(data_width)
    cum = torch.empty_like(bv_words)
    d_size = 0
    # a chunk at a time: int64 popcounts of a whole 2**32-bit vector would
    # take several GiB
    for i in range(0, bv_words.numel(), _FREEZE_CHUNK):
        pops = u64.popcount32(bv_words[i:i + _FREEZE_CHUNK])
        cum[i:i + pops.numel()] = torch.cumsum(pops, 0) - pops + d_size
        d_size += int(pops.sum())
        if d_size >= (1 << 31):
            raise NotImplementedError("MIBF of 2**31 set bits or more is "
                                      "not supported (ranks are int32)")
    return MIBloomFilter(
        bv_words=bv_words, cum_ranks=cum,
        rank_dir=mibf_rank.rank_directory(bv_words, cum),
        data=torch.zeros(d_size, dtype=STORAGE[data_width],
                         device=bv_words.device),
        size=size, hash_num=hash_num, kmer_size=kmer_size, d_size=d_size,
        data_width=data_width, sseeds=tuple(sseeds))


def from_numpy(bv_words_u32: np.ndarray, data: np.ndarray, *, size: int,
               hash_num: int, kmer_size: int, data_width: int,
               sseeds: Sequence[str] = (), device="cuda") -> MIBloomFilter:
    """A filter over the JAX package's state (``np.asarray(m.bv_words)``,
    ``np.asarray(m.data)``: at width 8 the uint32 [2, d_size] planes) on
    ``device``; the arrays are copied."""
    check_width(data_width)
    words = np.array(bv_words_u32, dtype=np.uint32)
    if words.shape != ((size + 31) // 32,):
        raise ValueError(f"expected {(size + 31) // 32} words for size "
                         f"{size}, got shape {words.shape}")
    m = freeze(torch.from_numpy(words.view(np.int32)).to(device), size,
               hash_num, kmer_size, data_width, sseeds)
    if data_width == 8:
        planes = np.asarray(data, dtype=np.uint32)
        if planes.shape != (2, m.d_size):
            raise ValueError(f"expected [2, {m.d_size}] uint32 planes, got "
                             f"shape {planes.shape}")
        ids = planes[0].astype(np.uint64) | (planes[1].astype(np.uint64)
                                             << np.uint64(32))
    else:
        ids = np.array(data, dtype=_NP[data_width])
    if ids.shape != (m.d_size,):
        raise ValueError(f"expected {m.d_size} IDs (the bit vector's "
                         f"popcount), got shape {ids.shape}")
    m.data = torch.from_numpy(ids.view(_NP_SIGNED[data_width])).to(device)
    return m


def ids_numpy(m: MIBloomFilter) -> np.ndarray:
    """The ID array on the host, numpy uint8 / 16 / 32 / 64: the reference's
    ``m_data``."""
    return m.data.cpu().numpy().view(_NP[m.data_width])


def to_numpy(m: MIBloomFilter):
    """(bv_words uint32, cum_ranks uint32, data) on the host: the JAX
    package's arrays, data uint8 / 16 / 32, or at width 8 its uint32 [2,
    d_size] planes."""
    ids = ids_numpy(m)
    return (m.bv_words.cpu().numpy().view(np.uint32),
            m.cum_ranks.cpu().numpy().view(np.uint32),
            u64_planes(ids) if m.data_width == 8 else ids)


# ---------------------------------------------------------------------------
# rank queries
# ---------------------------------------------------------------------------

def positions(m: MIBloomFilter, hashes: torch.Tensor) -> torch.Tensor:
    """hash % size of hashes int64 (uint64 bits) as int32 uint32 bits."""
    if m.size > MAX_SIZE:
        raise ValueError(f"MIBF of {m.size} bits: at most 2**32")
    return u64.to_u32_bits(u64.mod_const(hashes.to(m.device), m.size))


def rank_of_positions(m: MIBloomFilter, pos: torch.Tensor):
    """(rank int32, hit bool) of bit positions pos int32 (uint32 bits): rank
    = #1s strictly before pos (sdsl rank, MIBloomFilter.hpp:527)."""
    rank, hit, _ = mibf_rank.rank_lookup(m.bv_words, m.cum_ranks,
                                         m.rank_dir, pos.to(m.device))
    return rank, hit


def at_rank(m: MIBloomFilter, hashes: torch.Tensor):
    """atRank (MIBloomFilter.hpp:478-515) of hashes int64 [..., h]: (rank
    int32 [..., h], hit bool [..., h])."""
    return rank_of_positions(m, positions(m, hashes))


def at_rank_data(m: MIBloomFilter, hashes: torch.Tensor):
    """at_rank + getData in one lookup: (rank int32, hit bool, raw int64)
    shaped like hashes, raw = data[rank] as an unsigned value (at width 8
    the uint64 bits) with its saturation and strand bits, 0 where the bit
    vector missed."""
    rank, hit, raw = mibf_rank.rank_lookup(
        m.bv_words, m.cum_ranks, m.rank_dir, positions(m, hashes), m.data)
    return rank, hit, u64.unsigned(raw)


def at(m: MIBloomFilter, hashes: torch.Tensor, max_miss: int = 0):
    """`at` (MIBloomFilter.hpp:448-472): (values int64 [..., h], ok [...],
    frame_saturated [...]); ok marks frames with <= max_miss missing
    positions; values at missing slots are 0, saturation bits stripped."""
    _, hit, raw = at_rank_data(m, hashes)
    ok = (~hit).sum(dim=-1) <= max_miss
    sat = u64.gt_const(raw, m.s_mask)
    vals = torch.where(sat, raw & m.s_anti_mask, raw)
    # any miss or any non-saturated present value clears the frame's
    # saturated flag (MIBloomFilter.hpp:452-469)
    return vals, ok, (hit & sat).all(dim=-1)


# ---------------------------------------------------------------------------
# data mutation (in place)
# ---------------------------------------------------------------------------

def _in_range(m: MIBloomFilter, rank: torch.Tensor) -> torch.Tensor:
    """Ranks as int64 with those past the ID array dropped (the reference's
    scatter mode="drop")."""
    r = rank.reshape(-1).to(torch.int64).to(m.device)
    return r[(r >= 0) & (r < m.d_size)]


def saturate(m: MIBloomFilter, hashes: torch.Tensor) -> MIBloomFilter:
    """OR the saturation bit at every addressed rank
    (MIBloomFilter.hpp:440-446). Updates ``m.data`` in place."""
    rank, _ = at_rank(m, hashes)
    r = torch.unique(_in_range(m, rank))
    m.data[r] = to_storage(u64.unsigned(m.data[r]) | u64.as_signed(m.s_mask),
                           m.data_width)
    return m


def set_data(m: MIBloomFilter, rank: torch.Tensor,
             ids: torch.Tensor) -> MIBloomFilter:
    """Overwrite IDs at ranks, keeping each entry's saturation bit
    (setData, MIBloomFilter.hpp:625-634); of duplicate ranks the last wins.
    ``ids`` are unsigned values (at width 8 int64 holding the uint64 bits).
    Updates ``m.data`` in place."""
    r = rank.reshape(-1).to(torch.int64).to(m.device)
    v = torch.as_tensor(ids).reshape(-1).to(m.device).to(torch.int64)
    keep = (r >= 0) & (r < m.d_size)
    r, v = r[keep], v[keep]
    # the last occurrence of each rank: sort (rank, index) keys
    key = torch.sort((r << 32) | torch.arange(r.numel(), device=m.device))[0]
    last = torch.ones(key.numel(), dtype=torch.bool, device=m.device)
    last[:-1] = (key[1:] >> 32) != (key[:-1] >> 32)
    idx = key[last] & 0xFFFFFFFF
    r, v = r[idx], v[idx] & u64.as_signed(m.width_mask)
    m.data[r] = to_storage(
        v | (u64.unsigned(m.data[r]) & u64.as_signed(m.s_mask)),
        m.data_width)
    return m


# ---------------------------------------------------------------------------
# statistics (MIBloomFilter.hpp:539-620, 664-707)
# ---------------------------------------------------------------------------

def get_pop(m: MIBloomFilter) -> int:
    return m.d_size


def get_pop_non_zero(m: MIBloomFilter) -> int:
    return int((m.data != 0).sum())


def get_pop_saturated(m: MIBloomFilter) -> int:
    return int(u64.gt_const(u64.unsigned(m.data), m.s_mask).sum())


def _id_bins(ids: torch.Tensor, num_ids: int) -> torch.Tensor:
    """Histogram of stripped IDs over [0, num_ids); IDs past the table
    (at width 8, also those above 2**63) are dropped, as the reference's
    scatter drops them."""
    return torch.bincount(ids[(ids >= 0) & (ids < num_ids)],
                          minlength=num_ids)


def get_id_counts(m: MIBloomFilter, num_ids: int):
    """Histogram of stored IDs (getIDCounts, MIBloomFilter.hpp:539-551):
    (counts int64 [num_ids], saturated count)."""
    d = u64.unsigned(m.data)
    sat = u64.gt_const(d, m.s_mask)
    ids = torch.where(sat, d & m.s_anti_mask, d)
    return _id_bins(ids, num_ids), int(sat.sum())


def calc_frame_probs(m: MIBloomFilter, num_ids: int, allowed_miss: int):
    """calcFrameProbs (MIBloomFilter.hpp:664-679): per-ID frame match
    probabilities. Returns (frame_probs list, saturation proportion)."""
    occupancy = m.d_size / m.size
    counts, sat = get_id_counts(m, num_ids)
    counts = counts.cpu().numpy()
    total = int(counts[1:].sum())
    sat_prop = float(sat) / total if total else 0.0
    probs = [0.0] * num_ids
    for i in range(1, num_ids):
        probs[i] = calc_prob_single_frame(
            occupancy, m.hash_num, counts[i] / total if total else 0.0,
            allowed_miss)
    return probs, sat_prop


def get_id_counts_strand(m: MIBloomFilter, num_ids: int):
    """Histogram of stored IDs with the strand bit stripped
    (getIDCountsStrand, MIBloomFilter.hpp:557-569): a saturated entry keeps
    its ID bits (``s_id_mask``), any other loses only the strand bit.
    Returns (counts int64 [num_ids], saturated count)."""
    d = u64.unsigned(m.data)
    sat = u64.gt_const(d, m.s_mask)
    ids = torch.where(sat, d & m.s_id_mask,
                      d & u64.as_signed(m.width_mask & ~m.s_strand))
    return _id_bins(ids, num_ids), int(sat.sum())


def calc_frame_probs_strand(m: MIBloomFilter, num_ids: int,
                            allowed_miss: int):
    """calcFrameProbsStrand (MIBloomFilter.hpp:683-707): as
    :func:`calc_frame_probs` over :func:`get_id_counts_strand`, normalised,
    as the reference does, by the whole count table, index 0 included."""
    occupancy = m.d_size / m.size
    counts, sat = get_id_counts_strand(m, num_ids)
    counts = counts.cpu().numpy()
    total = int(counts.sum())
    sat_prop = float(sat) / total if total else 0.0
    probs = [0.0] * num_ids
    for i in range(1, num_ids):
        probs[i] = calc_prob_single_frame(
            occupancy, m.hash_num, counts[i] / total if total else 0.0,
            allowed_miss)
    return probs, sat_prop
