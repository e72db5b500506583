"""The reference's C++ class API over the port: the facade of the JAX
package's ``compat.py``, with its class and method names (down to the
reference's ``getRedudancyFPR`` spelling), so code written against the C++
headers (or the Perl/SWIG binding, which renames KmerBloomFilter to
BloomFilter::BloomFilter) ports mechanically.

Instances hold the port's filter state and update it in place; every call
goes through the port's model functions, so on the card the facade drives
the port's kernels. Hashes are precomputed hash arrays (numpy uint64 [h] for
one frame, [n, h] for n), as in the JAX facade. Constructors take
``device``: the card by default, ``device="cpu"`` for the plain path.
Width-8 MIBF filters (``data_width=8``) take and give IDs as Python ints or
numpy uint64; their random-order insert (``MIBloomFilter.insert``) and
their classification raise ``NotImplementedError``, as the reference has
neither.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .io import bf_format, mibf_format
from .models import bloom as bloom_mod
from .models import counting as counting_mod
from .models import kmer_bloom
from .models import mibf as mibf_mod
from .models import mibf_construct as construct
from .models import mibf_query
from .ops import nthash_tables, u64
from .utils import binomial


def _as_hashes(precomputed) -> torch.Tensor:
    """Precomputed hashes (numpy uint64 or Python ints) as int64 bits."""
    return u64.from_numpy(np.asarray(precomputed, dtype=np.uint64))


def _frames(hashes) -> torch.Tensor:
    """Hashes of one frame [h] or many [n, h] as int64 [n, h]."""
    t = _as_hashes(hashes)
    return t[None] if t.dim() == 1 else t


def _valid(valid, n: int) -> torch.Tensor:
    if valid is None:
        return torch.ones(n, dtype=torch.bool)
    return torch.as_tensor(np.asarray(valid, dtype=bool))


class BloomFilter:
    """Mirror of BloomFilter (BloomFilter.hpp)."""

    def __init__(self, *args, device="cuda"):
        if len(args) == 1 and isinstance(args[0], str):
            # BloomFilter(path), BloomFilter.hpp:101-105
            self._bf = bf_format.load_bloom(args[0], device=device)
        elif len(args) == 3:
            # BloomFilter(filterSize, hashNum, kmerSize), :65-76
            size, hash_num, kmer_size = args
            self._bf = bloom_mod.create(size, hash_num, kmer_size,
                                        device=device)
        elif len(args) == 4:
            # BloomFilter(expectedElemNum, fpr, hashNum, kmerSize), :83-99
            expected, fpr, hash_num, kmer_size = args
            self._bf = bloom_mod.create_from_fpr(expected, fpr, hash_num,
                                                 kmer_size, device=device)
        else:
            raise TypeError("bad constructor arguments")

    # insert / contains of precomputed hashes (BloomFilter.hpp:171-262)
    def insert(self, precomputed) -> None:
        bloom_mod.insert(self._bf, _as_hashes(precomputed))

    def insertAndCheck(self, precomputed) -> bool:
        _, found = bloom_mod.insert_and_check(self._bf,
                                              _as_hashes(precomputed))
        return bool(found)

    def contains(self, arg) -> bool:
        if isinstance(arg, str):
            return bool(kmer_bloom.contains_string(self._bf, arg))
        return bool(bloom_mod.contains(self._bf, _as_hashes(arg)))

    # serialization (BloomFilter.hpp:107-116, 304-314)
    def storeFilter(self, path: str) -> None:
        bf_format.store_bloom(self._bf, path)

    def loadFilter(self, path: str) -> None:
        self._bf = bf_format.load_bloom(path, device=self._bf.device)

    # stats and accessors (BloomFilter.hpp:316-379)
    def getPop(self) -> int:
        return bloom_mod.get_pop(self._bf)

    def getFPR(self) -> float:
        return bloom_mod.get_fpr(self._bf)

    def getFPR_numEle(self) -> float:
        return bloom_mod.get_fpr_num_ele(self._bf)

    def getRedudancyFPR(self) -> float:  # (sic: the reference's spelling)
        return bloom_mod.get_redundancy_fpr(self._bf)

    def getHashNum(self) -> int:
        return self._bf.hash_num

    def getKmerSize(self) -> int:
        return self._bf.kmer_size

    def getFilterSize(self) -> int:
        return self._bf.size

    def sizeInBytes(self) -> int:
        return self._bf.size_in_bytes

    def getnEntry(self) -> int:
        return self._bf.n_entry

    def gettEntry(self) -> int:
        return self._bf.t_entry

    def setnEntry(self, v: int) -> None:
        self._bf.n_entry = int(v)

    def settEntry(self, v: int) -> None:
        self._bf.t_entry = int(v)


class KmerBloomFilter(BloomFilter):
    """Mirror of KmerBloomFilter (KmerBloomFilter.hpp): hashes k-mer
    strings itself (ntHash, canonical)."""

    def insert(self, arg) -> None:
        if isinstance(arg, str):
            if len(arg) == self._bf.kmer_size:
                kmer_bloom.insert_kmers(self._bf,
                                        nthash_tables.encode_seq(arg))
            else:
                kmer_bloom.insert_string(self._bf, arg)
        else:
            super().insert(arg)


def insertSeq(bloom: BloomFilter, seq: str, hashNum: int = 0,
              kmerSize: int = 0) -> None:
    """Mirror of insertSeq (BloomFilterUtil.h:9-17)."""
    kmer_bloom.insert_string(bloom._bf, seq)


def calcApproxFPR(size: int, num_entr: int, hash_num: int) -> float:
    """BloomFilterUtil.h:28-33."""
    return math.pow(
        1.0 - math.pow(1.0 - 1.0 / float(size), float(num_entr) * hash_num),
        float(hash_num))


def calcRedunancyFPR(size: int, num_entr: int, hash_num: int) -> float:
    """BloomFilterUtil.h:38-46."""
    total = math.log(calcApproxFPR(size, 1, hash_num))
    for i in range(2, num_entr):
        total = math.log(math.exp(total) + calcApproxFPR(size, i, hash_num))
    return math.exp(total) / num_entr


class CountingBloomFilter:
    """Mirror of CountingBloomFilter<T> (CountingBloomFilter.hpp); T chosen
    by ``counter_width`` (bytes)."""

    def __init__(self, *args, counter_width: int = 1, device="cuda"):
        if len(args) == 2 and isinstance(args[0], str):
            path, threshold = args
            self._cbf = bf_format.load_counting(path, threshold,
                                                device=device)
        elif len(args) == 4:
            size_in_bytes, hash_num, kmer_size, threshold = args
            self._cbf = counting_mod.create(size_in_bytes, hash_num,
                                            kmer_size, threshold,
                                            counter_width, device=device)
        else:
            raise TypeError("bad constructor arguments")

    def insert(self, hashes) -> None:
        counting_mod.insert(self._cbf, _as_hashes(hashes))

    def insertAndCheck(self, hashes) -> bool:
        _, found = counting_mod.insert_and_check(self._cbf,
                                                 _as_hashes(hashes))
        return bool(found)

    def incrementAll(self, hashes) -> None:
        counting_mod.insert_all(self._cbf, _as_hashes(hashes))

    def contains(self, hashes) -> bool:
        return bool(counting_mod.contains(self._cbf, _as_hashes(hashes)))

    def minCount(self, hashes) -> int:
        return int(u64.to_numpy(counting_mod.min_count(
            self._cbf, _as_hashes(hashes)).reshape(1))[0])

    def __getitem__(self, i: int) -> int:
        if self._cbf.is_u64:
            return int(u64.to_numpy(self._cbf.counters[i].reshape(1))[0])
        per = self._cbf.counters_per_word
        bits = 32 // per
        w = int(self._cbf.counters[i // per]) & 0xFFFFFFFF
        return (w >> (bits * (i % per))) & ((1 << bits) - 1)

    def popCount(self) -> int:
        return counting_mod.pop_count(self._cbf)

    def filtered_popcount(self) -> int:
        return counting_mod.filtered_pop_count(self._cbf)

    def FPR(self) -> float:
        return counting_mod.fpr(self._cbf)

    def filtered_FPR(self) -> float:
        return counting_mod.filtered_fpr(self._cbf)

    def getKmerSize(self) -> int:
        return self._cbf.kmer_size

    def getHashNum(self) -> int:
        return self._cbf.hash_num

    def threshold(self) -> int:
        return self._cbf.count_threshold

    def size(self) -> int:
        return self._cbf.size

    def sizeInBytes(self) -> int:
        return self._cbf.size_in_bytes

    def storeFilter(self, path: str) -> None:
        bf_format.store_counting(self._cbf, path)

    def loadFilter(self, path: str) -> None:
        self._cbf = bf_format.load_counting(path, self._cbf.count_threshold,
                                            device=self._cbf.device)


# ---------------------------------------------------------------------------
# the MIBF stack (MIBloomFilter.hpp / MIBFConstructSupport.hpp /
# MIBFQuerySupport.hpp)
# ---------------------------------------------------------------------------

class MIBloomFilter:
    """Mirror of MIBloomFilter<T> (MIBloomFilter.hpp); T chosen by
    ``data_width`` (bytes: 1, 2, 4 or 8).

    Constructors:
      MIBloomFilter(path): load ``path`` and ``path.sdsl``
        (MIBloomFilter.hpp:149-261);
      MIBloomFilter(hashNum, kmerSize, bv): freeze a populated bit vector,
        a ``mibf_construct.BitVectorState`` or uint32 words (numpy or
        int32 tensor; ``size`` bits, by default all of the words'),
        MIBloomFilter.hpp:122-147.
    """

    def __init__(self, *args, data_width: int = 2, size: int | None = None,
                 sseeds: Sequence[str] = (), device="cuda"):
        if len(args) == 1 and isinstance(args[0], str):
            self._m = mibf_format.load_mibf(args[0], data_width=data_width,
                                            device=device)
        elif len(args) == 3:
            hash_num, kmer_size, bv = args
            if isinstance(bv, construct.BitVectorState):
                self._m = mibf_mod.freeze(bv.bv_words, bv.filter_size,
                                          hash_num, kmer_size,
                                          data_width=data_width,
                                          sseeds=bv.sseeds or sseeds)
            else:
                if not isinstance(bv, torch.Tensor):
                    bv = torch.from_numpy(np.asarray(bv, dtype=np.uint32)
                                          .view(np.int32).copy())
                bvw = bv.to(device)
                self._m = mibf_mod.freeze(bvw, size or bvw.numel() * 32,
                                          hash_num, kmer_size,
                                          data_width=data_width,
                                          sseeds=sseeds)
        else:
            raise TypeError("bad constructor arguments")

    # --- inserts (MIBloomFilter.hpp:312-446) -----------------------------
    def insert(self, hashes, *args):
        """insert(hashes, val, max) or insert(hashes, strand, val, max):
        per-frame success, a bool for one frame [h]."""
        arr = _frames(hashes)
        if len(args) == 2:
            (val, mx), strand = args, None
        else:
            strand, val, mx = args
            strand = torch.as_tensor(np.asarray(strand, bool)).reshape(
                arr.shape)
        _, ok = construct.insert_random_order_device(
            self._m, arr, int(val), int(mx), strand=strand)
        ok = ok.cpu().numpy()
        return bool(ok[0]) if np.ndim(hashes) == 1 else ok

    def saturate(self, hashes) -> None:
        """MIBloomFilter.hpp:440-446."""
        mibf_mod.saturate(self._m, _frames(hashes))

    # --- queries ----------------------------------------------------------
    def at(self, hashes, maxMiss: int = 0):
        """MIBloomFilter.hpp:448-472: (values numpy [h], ok, saturated)."""
        vals, ok, sat = mibf_mod.at(self._m, _frames(hashes), maxMiss)
        values = u64.to_numpy(vals[0]).astype(
            mibf_mod._NP[self._m.data_width])
        return values, bool(ok[0]), bool(sat[0])

    def atRank(self, hashes):
        """MIBloomFilter.hpp:478-515: (all hit, ranks numpy [h])."""
        rank, hit = mibf_mod.at_rank(self._m, _frames(hashes))
        return bool(hit.all()), rank[0].cpu().numpy()

    def getRankPos(self, hash_value: int) -> int:
        """MIBloomFilter.hpp:517-527."""
        pos = int(hash_value) % self._m.size
        rank, _ = mibf_mod.rank_of_positions(
            self._m, u64.to_u32_bits(torch.tensor([pos])))
        return int(rank[0])

    def getData(self, rank) -> int:
        return int(u64.to_numpy(u64.unsigned(
            self._m.data[int(rank)]).reshape(1))[0])

    def setData(self, rank: int, value: int) -> None:
        """MIBloomFilter.hpp:625-634 (saturation bit kept)."""
        mibf_mod.set_data(self._m, torch.tensor([int(rank)]),
                          torch.tensor([u64.as_signed(int(value))]))

    # --- stats ------------------------------------------------------------
    def getPop(self) -> int:
        return self._m.d_size

    def getPopNonZero(self) -> int:
        return mibf_mod.get_pop_non_zero(self._m)

    def getPopSaturated(self) -> int:
        return mibf_mod.get_pop_saturated(self._m)

    def getIDCounts(self, num_ids: int):
        counts, sat = mibf_mod.get_id_counts(self._m, num_ids)
        return counts.cpu().numpy(), sat

    def calcFrameProbs(self, num_ids: int, allowed_miss: int):
        return mibf_mod.calc_frame_probs(self._m, num_ids, allowed_miss)

    def calcFrameProbsStrand(self, num_ids: int, allowed_miss: int):
        return mibf_mod.calc_frame_probs_strand(self._m, num_ids,
                                                allowed_miss)

    def getKmerSize(self) -> int:
        return self._m.kmer_size

    def getHashNum(self) -> int:
        return self._m.hash_num

    def getSeedValues(self):
        return self._m.sseeds

    def size(self) -> int:
        return self._m.size

    def store(self, path: str) -> None:
        """MIBloomFilter.hpp:268-305 (writes ``path`` and ``path.sdsl``)."""
        mibf_format.store_mibf(self._m, path)


class MIBFConstructSupport:
    """Mirror of MIBFConstructSupport<T, H> (MIBFConstructSupport.hpp:
    36-214). The hash iterator is replaced by precomputed hash arrays
    (uint64 [frames, h]); ``valid`` (bool [frames]) masks frames."""

    def __init__(self, expected_entries: int, kmer_size: int, hash_num: int,
                 occupancy: float = 0.5, spaced_seeds: Sequence[str] = (),
                 device="cuda"):
        self._state = construct.create(expected_entries, kmer_size,
                                       hash_num, occupancy, spaced_seeds,
                                       device=device)
        self._counts = None

    def insertBV(self, hashes, valid=None) -> None:
        """Phase 1 (MIBFConstructSupport.hpp:75-87)."""
        arr = _frames(hashes)
        construct.insert_bv(self._state, arr, _valid(valid, arr.shape[0]))

    def insertBVColli(self, hashes, valid=None) -> int:
        """Phase 1 counting the frames whose bits were all set already
        (MIBFConstructSupport.hpp:55-73)."""
        arr = _frames(hashes)
        _, colli = construct.insert_bv_colli(self._state, arr,
                                             _valid(valid, arr.shape[0]))
        return colli

    def getEmptyMIBF(self, data_width: int = 2) -> MIBloomFilter:
        """Phase 2 (MIBFConstructSupport.hpp:92-99)."""
        wrapper = MIBloomFilter.__new__(MIBloomFilter)
        wrapper._m, self._counts = construct.get_empty_mibf(
            self._state, data_width=data_width)
        return wrapper

    def insertMIBF(self, mibf: MIBloomFilter, hashes, id_value: int,
                   valid=None) -> None:
        """Phase 3, reservoir sampling (MIBFConstructSupport.hpp:109-130)."""
        arr = _frames(hashes)
        construct.insert_mibf(mibf._m, self._counts, arr, int(id_value),
                              _valid(valid, arr.shape[0]))

    def insertSaturation(self, mibf: MIBloomFilter, hashes, id_value: int,
                         valid=None) -> None:
        """Phase 4 (MIBFConstructSupport.hpp:132-141 / 168-214)."""
        arr = _frames(hashes)
        construct.insert_saturation(mibf._m, self._counts, arr,
                                    int(id_value),
                                    _valid(valid, arr.shape[0]))


class MIBFQuerySupport:
    """Mirror of MIBFQuerySupport<T> (MIBFQuerySupport.hpp:33-130). Reads
    are precomputed hash arrays (uint64 [frames, h]); ``valid`` marks the
    frames the iterator yields."""

    def __init__(self, miBF: MIBloomFilter, perFrameProb: Sequence[float],
                 extraCount: int, extraFrameLimit: int, maxMiss: int,
                 minCount: int, bestHitAgree: bool):
        self._qs = mibf_query.MIBFQuerySupport(
            m=miBF._m, per_frame_prob=list(perFrameProb),
            extra_count=float(extraCount),
            extra_frame_limit=int(extraFrameLimit), max_miss=int(maxMiss),
            min_count=int(minCount), best_hit_agree=bool(bestHitAgree))

    def query(self, hashes, minCount, valid=None):
        """MIBFQuerySupport.hpp:94-109: the ranked QueryResult list."""
        arr = _frames(hashes)
        return self._qs.query(arr, _valid(valid, arr.shape[0]),
                              torch.as_tensor(np.asarray(minCount, np.int32)))

    def queryPaired(self, hashes1, hashes2, minCount, valid1=None,
                    valid2=None):
        """MIBFQuerySupport.hpp:111-130."""
        a1, a2 = _frames(hashes1), _frames(hashes2)
        return self._qs.query_paired(
            a1, _valid(valid1, a1.shape[0]), a2,
            _valid(valid2, a2.shape[0]),
            torch.as_tensor(np.asarray(minCount, np.int32)))

    def getMatchSignature(self, hashes, valid=None):
        """MIBFQuerySupport.hpp:158-217."""
        arr = _frames(hashes)
        return self._qs.get_match_signature(arr,
                                            _valid(valid, arr.shape[0]))

    def calcSat(self, evaluatedValues: int, singleEventProbSaturted: float,
                saturatedCount: int) -> float:
        """MIBFQuerySupport.hpp:544-553: the binomial CDF of the
        saturation count (``utils/binomial.py``)."""
        return binomial.calc_sat(int(evaluatedValues),
                                 float(singleEventProbSaturted),
                                 int(saturatedCount))

    def getSatCount(self) -> int:
        return self._qs.sat_count

    def getEvaluatedValues(self) -> int:
        return self._qs.eval_count
