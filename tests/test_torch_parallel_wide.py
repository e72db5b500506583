"""The port's sharded Bloom, counting and MIBF filters past 2**32 bits and
counters, on gloo rank processes at P = 2, 4 and 8: positions split into
(owner, local offset) in 64 bits, each shard below 2**32. As
``tests/test_parallel.py``'s three cases of this size, they are held
against Python models (the set bits, a conservative-update loop, the
rank of a position as the count of unique inserted positions below it,
the reservoir in sorted-value order), not against JAX. A file of its own:
the counting case holds a 4 GiB plane across the ranks.
"""

import collections

import numpy as np
import pytest

from btl_bloomfilter_tpu_torch.parallel import dist_bloom as t_dist_bloom

import torch_parallel_cases as cases
from torch_parallel_cases import joined


@pytest.fixture(scope="module", params=[2, 4, 8])
def ranks(request, tmp_path_factory):
    p = request.param
    return p, cases.run_cases(tmp_path_factory.mktemp(f"wide{p}"),
                              cases.WIDE_CASES, p)


def test_sharded_bloom_beyond_2_32_bits(ranks):
    """The set bits are those of the positions, words joined in rank
    order; every inserted frame hits; a probe hits iff its bits are set;
    ``rerouted`` is the positions past each owner's default cap (the
    values past 2**32 all fall on the last shard)."""
    p, out = ranks
    c = cases.W_BLOOM
    vals, rng = cases.wide_values(c, c["size"])
    shard = c["size"] // p
    per = c["n"] // p
    cap = t_dist_bloom._default_cap(per * c["h"], p)
    rerouted = sum(
        max(k - cap, 0) for r in range(p) for k in np.bincount(
            (vals[r * per:(r + 1) * per].reshape(-1) % np.uint64(c["size"])
             // np.uint64(shard)).astype(np.int64), minlength=p))
    bits = {}
    for x in vals.reshape(-1):
        pos = int(x) % c["size"]
        bits.setdefault(pos >> 5, 0)
        bits[pos >> 5] |= 1 << (pos & 31)
    outs = out("bloom_wide")
    got = {}
    for r, o in enumerate(outs):
        base = r * int(o["words_per_shard"])
        got.update({base + int(i): int(w)
                    for i, w in zip(o["idx"], o["words"])})
        assert int(o["rerouted"]) == rerouted
    assert got == bits
    assert joined(outs, "hits").all()
    probes = rng.integers(0, c["size"], size=(c["probes"], c["h"]),
                          dtype=np.uint64)
    exp = [all((bits.get((int(x) % c["size"]) >> 5, 0)
                >> ((int(x) % c["size"]) & 31)) & 1 for x in row)
           for row in probes]
    np.testing.assert_array_equal(joined(outs, "probe_hits").reshape(-1),
                                  exp)


def test_sharded_counting_beyond_2_32_counters(ranks):
    """Conservative insert, min count and incrementAll through 64-bit
    (owner, local) splits, against a Python conservative-update model of
    the touched counters (CountingBloomFilter.hpp:135-162)."""
    p, out = ranks
    c = cases.W_COUNTING
    outs = out("counting_wide")
    size = int(outs[0]["size"])
    assert size > (1 << 32)
    vals, _ = cases.wide_values(c, size, repeat=8)

    def plane(key_idx, key_words):
        """Counter index -> value of the non-zero u8 counters, joined."""
        res = {}
        for r, o in enumerate(outs):
            base = r * int(o["shard_size"])
            for i, w in zip(o[key_idx], o[key_words].view(np.uint32)):
                for lane in range(4):
                    v = (int(w) >> (8 * lane)) & 0xFF
                    if v:
                        res[base + 4 * int(i) + lane] = v
        return res

    model = {}
    for row in vals:
        pos = [int(x) % size for x in row]
        mn = min(model.get(p0, 0) for p0 in pos)
        for p0 in pos:
            if model.get(p0, 0) == mn:
                model[p0] = mn + 1
    assert plane("idx", "words") == model
    exp = [min(model[int(x) % size] for x in row) for row in vals]
    np.testing.assert_array_equal(joined(outs, "min_count").reshape(-1), exp)
    occ = collections.Counter(int(x) % size for x in vals.reshape(-1))
    assert plane("idx_all", "words_all") == {
        p0: model[p0] + n for p0, n in occ.items()}


def test_sharded_mibf_beyond_2_32_bits(ranks):
    """Build, reservoir insert and rank / ID lookups of a 2**32 + 2048-bit
    MIBF: the rank of a position is the count of unique inserted
    positions below it, and each rank's ID follows the reservoir in the
    framework's sorted-value order (width 2)."""
    p, out = ranks
    c = cases.W_MIBF
    vals, rng = cases.wide_values(c, c["size"], repeat=4)
    n, h, size, idv = c["n"], c["h"], c["size"], c["id"]
    pos_all = sorted({int(x) % size for x in vals.reshape(-1)})
    pos_index = {p0: i for i, p0 in enumerate(pos_all)}
    counts_model = collections.Counter()
    data_model = {}
    for v in sorted({int(x) for x in vals.reshape(-1)}):
        rk = pos_index[v % size]
        counts_model[rk] += 1
        cnt = counts_model[rk]
        if ((v ^ idv) & 0xFFFF) % cnt == cnt - 1:
            data_model[rk] = idv
    outs = out("mibf_wide")
    for o in outs:
        assert int(o["d_size"]) == len(pos_all)
    assert joined(outs, "hit").all()
    rank = joined(outs, "rank").reshape(n, h)
    raw = joined(outs, "raw").reshape(n, h)
    for i, row in enumerate(vals):
        for j, x in enumerate(row):
            rk = pos_index[int(x) % size]
            assert rank[i, j] == rk
            assert raw[i, j] == data_model.get(rk, 0)
    probes = rng.integers(0, size, size=(c["probes"], h), dtype=np.uint64)
    inserted = set(pos_all)
    hit2 = joined(outs, "probe_hit").reshape(c["probes"], h)
    for i, row in enumerate(probes):
        for j, x in enumerate(row):
            assert hit2[i, j] == (int(x) % size in inserted)
