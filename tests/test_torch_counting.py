"""The port's counting Bloom filter (plain PyTorch path) against the JAX
package: counter state after conservative update (grouped and ungrouped,
with the entangled-overflow and long-chain fallbacks) and incrementAll,
min counts, membership, stats, the state carried between the two packages,
the kernels' plain versions against the JAX kernels in interpret mode, and
the counting ``.bf`` bytes against the C++-derived golden files.

Inputs are made with numpy from fixed seeds and handed to both sides. The
compared outputs are integers, bools or bytes, so the tolerance is zero,
except the float FPR, which the JAX package computes in float32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.io import bf_format as jax_bf_format
from btl_bloomfilter_tpu.kernels import gather_words as jax_gather_words
from btl_bloomfilter_tpu.kernels import scatter_add as jax_scatter_add
from btl_bloomfilter_tpu.kernels import scatter_or as jax_scatter_or
from btl_bloomfilter_tpu.models import counting as jax_counting
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.io import bf_format
from btl_bloomfilter_tpu_torch.kernels import gather_counters, scatter_add
from btl_bloomfilter_tpu_torch.models import counting
from btl_bloomfilter_tpu_torch.ops import nthash, nthash_tables, u64

from util import golden_long_seq

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
CBF_SEQ = "ACGTACACTGGACTGAGTCT"
SENT = 0xFFFFFFFF
NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}

# jitted JAX references: eager JAX dispatches op by op and is slow on the CPU
jax_insert = jax.jit(jax_counting.insert,
                     static_argnames=("max_entangled", "group_duplicates"))
jax_insert_sequential = jax.jit(jax_counting.insert_sequential)
jax_insert_all = jax.jit(jax_counting.insert_all)
jax_min_count = jax.jit(jax_counting.min_count)
jax_contains = jax.jit(jax_counting.contains)
jax_insert_and_check = jax.jit(jax_counting.insert_and_check)
jax_hash_frames = jax.jit(jax_nthash.hash_frames, static_argnums=(1, 2))
jax_insert_positions = jax.jit(jax_counting.insert_positions,
                               static_argnums=(3, 4, 5))
jax_insert_positions_u64 = jax.jit(jax_counting.insert_positions_u64,
                                   static_argnums=(4,))


def golden_bytes(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def jax_state(jcbf):
    return np.asarray(jcbf.counters)


def pair(cbf, jcbf):
    """Hold the port's state equal to the JAX state, in both layouts."""
    np.testing.assert_array_equal(counting.to_numpy_counters(cbf),
                                  jax_state(jcbf))
    np.testing.assert_array_equal(counting.to_numpy(cbf),
                                  jax_counting.to_numpy(jcbf))


def stream(n, h, repeat, seed, vfrac=0.9):
    """(hashes uint64 [N, h], valid bool [N]) as the JAX package's
    conservative-update tests make them: random frames, each repeated
    ``repeat`` times in a shuffled order."""
    r = np.random.default_rng(seed)
    hi = r.integers(0, 1 << 32, size=(n, h), dtype=np.uint32)
    lo = r.integers(0, 1 << 32, size=(n, h), dtype=np.uint32)
    hs = (hi.astype(np.uint64) << np.uint64(32)) | lo
    if repeat > 1:
        ridx = np.tile(np.arange(n), repeat)
        np.random.default_rng(seed + 100).shuffle(ridx)
        hs = hs[ridx]
    valid = np.random.default_rng(seed + 7).random(hs.shape[0]) < vfrac
    return hs, valid


def both(size_bytes, h, width, threshold=1, k=5):
    return (counting.create(size_bytes, h, k, threshold, counter_width=width,
                            device="cpu"),
            jax_counting.create(size_bytes, h, k, threshold,
                                counter_width=width))


def np_conservative(pos, v, size, dtype=np.uint8):
    """Stream-order numpy oracle of incrementMin."""
    ref = np.zeros(size, dtype)
    top = np.iinfo(dtype).max
    for p, ok in zip(pos, v):
        if not ok:
            continue
        cur = ref[p]
        m = cur.min()
        if m == top:
            continue
        upd = cur.copy()
        upd[cur == m] = m + 1
        ref[p] = upd
    return ref


# ---------------------------------------------------------------------------
# conservative update
# ---------------------------------------------------------------------------

# the streams of the JAX package's batched-vs-sequential tests
STREAMS = [  # n, h, size_bytes, repeat, width, seed
    (500, 3, 4096, 1, 1, 1),    # sparse random, few collisions
    (400, 3, 256, 1, 1, 2),     # dense -> heavy entanglement
    (300, 4, 2048, 8, 1, 3),    # high-multiplicity groups (coverage-like)
    (64, 2, 64, 30, 1, 4),      # tiny filter: entanglement + u8 freeze
    (200, 3, 1024, 4, 8, 5),    # u64-width counters
    (300, 3, 4096, 2, 2, 5),    # u16
    (250, 3, 8192, 2, 4, 6),    # u32
]


@pytest.mark.parametrize("n,h,size_bytes,repeat,width,seed", STREAMS)
def test_conservative_update_matches_jax_stream_order(
        n, h, size_bytes, repeat, width, seed):
    hs, valid = stream(n, h, repeat, seed)
    cbf, jcbf = both(size_bytes, h, width)
    ref = jax_insert_sequential(jcbf, jax_u64.from_numpy(hs),
                                jnp.asarray(valid))
    hs_t, v_t = u64.from_numpy(hs), torch.from_numpy(valid)
    pair(counting.insert_sequential(cbf, hs_t, v_t), ref)
    for group in (True, False):
        cbf, _ = both(size_bytes, h, width)
        pair(counting.insert(cbf, hs_t, v_t, group_duplicates=group), ref)


@pytest.mark.parametrize("stream_idx,group", [(1, True), (2, True),
                                              (3, False), (4, True),
                                              (5, False)])
def test_insert_matches_jax_insert(stream_idx, group):
    n, h, size_bytes, repeat, width, seed = STREAMS[stream_idx]
    hs, valid = stream(n, h, repeat, seed)
    cbf, jcbf = both(size_bytes, h, width)
    ref = jax_insert(jcbf, jax_u64.from_numpy(hs), jnp.asarray(valid),
                     group_duplicates=group)
    got = counting.insert(cbf, u64.from_numpy(hs), torch.from_numpy(valid),
                          group_duplicates=group)
    pair(got, ref)


@pytest.mark.parametrize("group", [True, False])
def test_entangled_overflow_fallback_matches_jax(group):
    """More entangled frames than max_entangled: the whole batch replays
    (the JAX package runs its per-frame scan)."""
    hs, _ = stream(300, 3, 1, 11)
    cbf, jcbf = both(128, 3, 1)
    ref = jax_insert(jcbf, jax_u64.from_numpy(hs), max_entangled=16)
    got = counting.insert(cbf, u64.from_numpy(hs), max_entangled=16,
                          group_duplicates=group)
    pair(got, ref)


@pytest.mark.parametrize("chain_len", [5, 20, 40])
def test_replay_chains_match_jax(chain_len):
    """Dependency chains through shared positions, longer than the JAX
    scheduler's 32-round bound at 40, a masked frame inside the chain and
    an in-frame duplicate entangled with the chain head."""
    size = 512
    pos = np.array([[i, i + 1, 200 + (i % 100)] for i in range(chain_len)],
                   np.uint32)
    pos = np.vstack([pos, np.array([[0, 0, 400]], np.uint32)])
    v = np.ones(len(pos), bool)
    v[2] = False
    ref = jax_insert_positions(
        jnp.zeros(size // 4, jnp.uint32), jnp.asarray(pos), jnp.asarray(v),
        255, size, 4)
    for group in (True, False):
        got = counting.insert_positions(
            torch.zeros(size // 4, dtype=torch.int32),
            torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(v),
            255, size, 4, group=group)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(ref))
    np.testing.assert_array_equal(
        np.asarray(ref).astype("<u4").view(np.uint8),
        np_conservative(pos, v, size))


def test_replay_chains_u64_match_jax():
    size = 256
    pos = np.array([[i, i + 1, 100 + i] for i in range(12)], np.uint32)
    v = np.ones(len(pos), bool)
    lo, hi = jax_insert_positions_u64(
        jnp.zeros(size, jnp.uint32), jnp.zeros(size, jnp.uint32),
        jnp.asarray(pos), jnp.asarray(v), size)
    ref = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32))
    got = counting.insert_positions_u64(
        torch.zeros(size, dtype=torch.int64),
        torch.from_numpy(pos.astype(np.int64)), torch.from_numpy(v), size)
    np.testing.assert_array_equal(u64.to_numpy(got), ref)
    np.testing.assert_array_equal(ref, np_conservative(pos, v, size,
                                                       np.uint64))


def test_insert_and_check_matches_jax():
    hs, valid = stream(120, 3, 2, 8)
    cbf, jcbf = both(512, 3, 1, threshold=1)
    for chunk in (slice(0, 120), slice(120, 240)):
        jcbf, jfound = jax_insert_and_check(
            jcbf, jax_u64.from_numpy(hs[chunk]), jnp.asarray(valid[chunk]))
        cbf, found = counting.insert_and_check(
            cbf, u64.from_numpy(hs[chunk]), torch.from_numpy(valid[chunk]))
        np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
        pair(cbf, jcbf)
    assert found.any() and not found.all()


# ---------------------------------------------------------------------------
# incrementAll, queries, stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,size_bytes", [(1, 16), (1, 4096), (2, 512),
                                              (4, 1000), (8, 800)])
def test_insert_all_queries_and_stats_match_jax(width, size_bytes):
    """incrementAll with duplicates (a tiny u8 filter saturates), then min
    count, membership at threshold 2, pop counts and FPR."""
    rng = np.random.default_rng(width * 1000 + size_bytes)
    h = 3
    hs = rng.integers(0, 1 << 64, size=(40, 30, h), dtype=np.uint64)
    hs[20:] = hs[:20]                       # repeated frames
    valid = rng.random((40, 30)) < 0.9
    cbf, jcbf = both(size_bytes, h, width, threshold=2)
    jcbf = jax_insert_all(jcbf, jax_u64.from_numpy(hs), jnp.asarray(valid))
    jcbf = jax_insert_all(jcbf, jax_u64.from_numpy(hs[:10]))
    counting.insert_all(cbf, u64.from_numpy(hs), torch.from_numpy(valid))
    counting.insert_all(cbf, u64.from_numpy(hs[:10]))
    pair(cbf, jcbf)
    if size_bytes == 16:
        assert (counting.to_numpy(cbf) == 255).any()   # saturated

    probe = np.concatenate([hs[:5], rng.integers(
        0, 1 << 64, size=(5, 30, h), dtype=np.uint64)])
    ref_mc = jax_min_count(jcbf, jax_u64.from_numpy(probe))
    ref_mc = (ref_mc.astype_numpy() if width == 8
              else np.asarray(ref_mc).astype(np.uint64))
    mc = counting.min_count(cbf, u64.from_numpy(probe))
    np.testing.assert_array_equal(u64.to_numpy(mc), ref_mc)
    np.testing.assert_array_equal(
        counting.contains(cbf, u64.from_numpy(probe)).numpy(),
        np.asarray(jax_contains(jcbf, jax_u64.from_numpy(probe))))

    assert counting.pop_count(cbf) == int(jax_counting.pop_count(jcbf))
    assert counting.filtered_pop_count(cbf) == \
        int(jax_counting.filtered_pop_count(jcbf))
    # the JAX package's FPR is float32 (XLA's pow, denormals flushed): its
    # rounding bounds the difference
    for got, ref in ((counting.fpr(cbf), jax_counting.fpr(jcbf)),
                     (counting.filtered_fpr(cbf),
                      jax_counting.filtered_fpr(jcbf))):
        assert abs(got - float(ref)) <= 1e-6 * got + 1e-37


def test_width8_conservative_update_crosses_2_32():
    h = 2
    base = np.array([(1 << 32) - 1, (1 << 32) - 1, (1 << 33) + 5,
                     7, 0, (1 << 40), 3, 12], dtype=np.uint64)
    hs = np.array([[0, 1], [0, 1], [2, 5], [4, 3]], dtype=np.uint64)
    kw = dict(size=8, hash_num=h, kmer_size=5, count_threshold=1,
              counter_width=8)
    jcbf = jax_counting.from_bytes(base.astype("<u8").tobytes(), **kw)
    ref = jax_insert_sequential(jcbf, jax_u64.from_numpy(hs))
    for group in (True, False):
        cbf = counting.from_bytes(base.astype("<u8").tobytes(), **kw,
                                  device="cpu")
        pair(counting.insert(cbf, u64.from_numpy(hs),
                             group_duplicates=group), ref)
    assert counting.to_numpy(cbf)[0] == (1 << 32) + 1


def test_width8_increment_all_carry_and_freeze():
    base = np.array([(1 << 32) - 3, (1 << 48), 0, 5,
                     0xFFFFFFFFFFFFFFFF, 1, 2, 3], dtype=np.uint64)
    kw = dict(size=8, hash_num=1, kmer_size=5, count_threshold=1,
              counter_width=8)
    hs = np.concatenate([np.zeros((10, 1), np.uint64),
                         np.full((4, 1), 1, np.uint64),
                         np.full((3, 1), 4, np.uint64)])
    jcbf = jax_counting.from_bytes(base.astype("<u8").tobytes(), **kw)
    cbf = counting.from_bytes(base.astype("<u8").tobytes(), **kw, device="cpu")
    pair(counting.insert_all(cbf, u64.from_numpy(hs)),
         jax_insert_all(jcbf, jax_u64.from_numpy(hs)))
    got = counting.to_numpy(cbf)
    assert got[0] == (1 << 32) + 7 and got[4] == 0xFFFFFFFFFFFFFFFF
    # conservative update freezes at 2**64-1 too
    cbf = counting.from_bytes(base.astype("<u8").tobytes(), **kw, device="cpu")
    counting.insert(cbf, u64.from_numpy(np.full((3, 1), 4, np.uint64)))
    np.testing.assert_array_equal(counting.to_numpy(cbf), base)


def test_width8_min_count_contains_and_stats_cross_2_32():
    base = np.array([(1 << 35), (1 << 35) + 9, 6, (1 << 32),
                     0, 0, 1, 2], dtype=np.uint64)
    thr = 1 << 34
    kw = dict(size=8, hash_num=2, kmer_size=5, count_threshold=thr,
              counter_width=8)
    jcbf = jax_counting.from_bytes(base.astype("<u8").tobytes(), **kw)
    cbf = counting.from_bytes(base.astype("<u8").tobytes(), **kw, device="cpu")
    hs = np.array([[0, 1], [2, 3], [1, 3]], dtype=np.uint64)
    mc = counting.min_count(cbf, u64.from_numpy(hs))
    np.testing.assert_array_equal(
        u64.to_numpy(mc),
        jax_min_count(jcbf, jax_u64.from_numpy(hs)).astype_numpy())
    np.testing.assert_array_equal(u64.to_numpy(mc), [1 << 35, 6, 1 << 32])
    np.testing.assert_array_equal(
        counting.contains(cbf, u64.from_numpy(hs)).numpy(), [True, False,
                                                             False])
    assert counting.pop_count(cbf) == int(jax_counting.pop_count(jcbf)) == 6
    assert counting.filtered_pop_count(cbf) == \
        int(jax_counting.filtered_pop_count(jcbf)) == 2


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def packed(counters):
    """Per-counter numpy array -> (JAX uint32 words, port int32 words)."""
    words = np.frombuffer(counters.astype(counters.dtype.newbyteorder("<"))
                          .tobytes(), dtype="<u4").astype(np.uint32)
    return jnp.asarray(words), torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("width", [1, 2, 4])
def test_scatter_add_plain_matches_jax_kernel(width):
    """Weighted and unit saturating adds into one kernel window of
    counters, with duplicates, zero increments and saturation."""
    rng = np.random.default_rng(width)
    per = 4 // width
    ncounters = jax_scatter_or.WIN_WORDS * per
    cmax = (1 << (8 * width)) - 1
    counters = rng.integers(0, min(cmax, 250), size=ncounters).astype(
        NP_DTYPE[width])
    idx = rng.integers(0, ncounters, size=3000, dtype=np.uint32)
    idx[:300] = idx[0]
    counters[idx[0]] = cmax - 5
    # the JAX kernel takes increments up to the lane maximum (bf16 bytes)
    vals = rng.integers(0, min(cmax, 300), size=3000, dtype=np.uint32)
    vals[1000:1200] = 0
    order = np.argsort(idx)
    shift = {4: 2, 2: 1, 1: 0}[per]

    jw, tw = packed(counters)
    ref, ovf = jax_scatter_add.scatter_add_weighted_sorted(
        jw, jnp.asarray(idx[order]), jnp.asarray(vals[order]), per, cmax,
        interpret=True)
    assert (np.asarray(ovf) == SENT).all()
    got = scatter_add.scatter_add(
        tw, torch.from_numpy(idx.view(np.int32)), shift, cmax,
        inc=torch.from_numpy(vals.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))

    jw, tw = packed(counters)
    ref, _ = jax_scatter_add.scatter_add_sorted(
        jw, jnp.asarray(np.sort(idx)), per, cmax, interpret=True)
    got = scatter_add.scatter_add(tw, torch.from_numpy(idx.view(np.int32)),
                                  shift, cmax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref))


@pytest.mark.parametrize("width", [1, 2, 4])
def test_gather_counters_plain_matches_jax_kernel(width):
    rng = np.random.default_rng(10 + width)
    per = 4 // width
    size_bytes = jax_scatter_or.WIN_WORDS * 4    # one kernel window
    jcbf = jax_counting.create(size_bytes, 5, 8, 3, counter_width=width)
    vals = rng.integers(0, min(jcbf.counter_max, 200),
                        size=jcbf.size).astype(NP_DTYPE[width])
    jw, tw = packed(vals)
    jcbf = jax_counting.CountingBloomFilter(
        counters=jw, size=jcbf.size, hash_num=5, kmer_size=8,
        count_threshold=3, counter_width=width)
    pos = rng.integers(0, jcbf.size, size=(37, 5), dtype=np.uint32)
    ref, over = jax_counting.gather_counters_kernel(jcbf, jnp.asarray(pos),
                                                    interpret=True)
    assert int(over) == 0
    planes = torch.from_numpy(pos.T.copy().view(np.int32))
    shift = {4: 2, 2: 1, 1: 0}[per]
    got = gather_counters.gather_counters(tw, planes, shift, "vals")
    np.testing.assert_array_equal(got.numpy().T, np.asarray(ref))
    np.testing.assert_array_equal(
        gather_counters.gather_counters(tw, planes, shift, "min").numpy(),
        np.asarray(ref).min(axis=1))
    np.testing.assert_array_equal(
        gather_counters.gather_counters(tw, planes, shift, "hit", 3).numpy(),
        np.asarray(ref).min(axis=1) >= 3)
    # the JAX windowed kernel in counter mode reads the same words
    w_s, _ = jax_gather_words.gather_words_sorted(
        jw, jnp.asarray(np.sort(pos.reshape(-1))), shift=shift,
        interpret=True)
    np.testing.assert_array_equal(
        np.asarray(w_s),
        tw.numpy().view(np.uint32)[np.sort(pos.reshape(-1)) >> shift])


def test_gather_counters_plain_sentinels_and_clamp():
    words = torch.tensor([0x04030201, 0x08070605, -1], dtype=torch.int32)
    pos = torch.tensor([[0, -1, 5, 11, 40], [3, 1, -1, 7, 2]],
                       dtype=torch.int32)
    vals = gather_counters.gather_counters(words, pos, 2, "vals")
    # a sentinel slot reads 0; counter 40 (word 10) clamps to the last word
    assert vals.tolist() == [[1, 0, 6, 255, 255], [4, 2, 0, 8, 3]]
    assert gather_counters.gather_counters(words, pos, 2, "min").tolist() \
        == [1, 0, 0, 8, 3]
    assert gather_counters.gather_counters(words, pos, 2, "hit", 3
                                           ).tolist() == [False, False,
                                                          False, True, True]


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_scatter_add_plain_saturates_within_lanes(shift):
    per, bits = 1 << shift, 32 >> shift
    cmax = (1 << bits) - 1
    words = torch.zeros(3, dtype=torch.int32)
    # counter 0 gets cmax + 5 in three pairs, counter 1 gets 2; a sentinel
    # and a position past the words add nothing
    pos = torch.tensor([0, 0, 0, 1, -1, 3 * per], dtype=torch.int32)
    inc = u64.to_u32_bits(torch.tensor([cmax - 1, 3, 3, 2, 9, 9]))
    scatter_add.scatter_add(words, pos, shift, cmax, inc=inc)
    lanes = np.frombuffer(words.numpy().astype("<i4").tobytes(),
                          dtype={0: "<u4", 1: "<u2", 2: "<u1"}[shift])
    assert lanes[0] == cmax and lanes[1] == 2 and lanes[2:].sum() == 0


# ---------------------------------------------------------------------------
# the slice as a whole: codes -> hash -> insert -> query
# ---------------------------------------------------------------------------

def random_codes(B, L, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    return np.where(rng.random((B, L)) < nfrac, np.uint8(4), codes)


@pytest.mark.parametrize("width,group", [(1, False), (2, True), (8, True)])
def test_codes_to_counts_match_jax(width, group):
    """Two batches, the second repeating half of the first's reads, go
    through JAX hash_frames -> counting.insert -> contains, and through the
    port by both routes: the hashes (nthash.hash_frames -> insert ->
    contains) and the positions planes (insert_seq -> contains_seq)."""
    k, h, size_bytes = 11, 3, 3000
    a = random_codes(6, 90, 0.05, 1)
    b = np.concatenate([a[:3], random_codes(3, 90, 0.05, 2)])
    jcbf = jax_counting.create(size_bytes, h, k, 2, counter_width=width)
    by_hash = counting.create(size_bytes, h, k, 2, counter_width=width,
                              device="cpu")
    by_pos = counting.create(size_bytes, h, k, 2, counter_width=width,
                             device="cpu")
    for codes in (a, b):
        f = jax_hash_frames(jnp.asarray(codes), k, h)
        jcbf = jax_insert(jcbf, f.hashes, f.valid, group_duplicates=group)
        pf = nthash.hash_frames(torch.from_numpy(codes), k, h)
        counting.insert(by_hash, pf.hashes, pf.valid,
                        group_duplicates=group)
        counting.insert_seq(by_pos, codes, group_duplicates=group)
        pair(by_hash, jcbf)
        pair(by_pos, jcbf)
    for codes in (a, b, random_codes(6, 90, 0.05, 3)):
        f = jax_hash_frames(jnp.asarray(codes), k, h)
        ref = np.asarray(jax_contains(jcbf, f.hashes) & f.valid)
        pf = nthash.hash_frames(torch.from_numpy(codes), k, h)
        np.testing.assert_array_equal(
            (counting.contains(by_hash, pf.hashes) & pf.valid).numpy(), ref)
        hit, valid = counting.contains_seq(by_pos, codes)
        np.testing.assert_array_equal(hit.numpy(), ref)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(f.valid))
        mc, _ = counting.min_count_seq(by_pos, codes)
        ref_mc = jax_min_count(jcbf, f.hashes)
        ref_mc = (ref_mc.astype_numpy() if width == 8
                  else np.asarray(ref_mc).astype(np.uint64))
        np.testing.assert_array_equal(
            u64.to_numpy(mc), np.where(np.asarray(f.valid), ref_mc, 0))


def test_state_carried_from_jax_and_back():
    """A JAX-built filter moves into the port, is queried and extended
    there, and moves back, for every width."""
    k, h = 9, 3
    a, b = random_codes(4, 80, 0.05, 4), random_codes(4, 80, 0.05, 5)
    for width in (1, 2, 4, 8):
        jcbf = jax_counting.create(777, h, k, 1, counter_width=width)
        f = jax_hash_frames(jnp.asarray(a), k, h)
        jcbf = jax_insert_all(jcbf, f.hashes, f.valid)
        cbf = counting.from_numpy_counters(
            jax_state(jcbf), size=jcbf.size, hash_num=h, kmer_size=k,
            count_threshold=1, counter_width=width, device="cpu")
        pair(cbf, jcbf)
        fb = jax_hash_frames(jnp.asarray(b), k, h)
        jcbf = jax_insert(jcbf, fb.hashes, fb.valid)
        counting.insert_seq(cbf, b)
        pair(cbf, jcbf)
        back = jax_counting.CountingBloomFilter(
            counters=jnp.asarray(counting.to_numpy_counters(cbf)),
            size=cbf.size, hash_num=h, kmer_size=k, count_threshold=1,
            counter_width=width)
        np.testing.assert_array_equal(
            np.asarray(jax_contains(back, f.hashes)),
            np.asarray(jax_contains(jcbf, f.hashes)))
    with pytest.raises(ValueError):
        counting.from_numpy_counters(np.zeros(3, np.uint32), size=64,
                                     hash_num=1, kmer_size=5,
                                     count_threshold=1, counter_width=1,
                                     device="cpu")


def test_size_rules():
    cbf = counting.create(1001, 4, 6, 2, device="cpu")
    assert (cbf.size, cbf.size_in_bytes, cbf.nwords) == (1008, 1008, 252)
    assert counting.create(1001, 4, 6, 2, counter_width=8,
                           device="cpu").size == 126
    with pytest.raises(ValueError):
        counting.create(64, 2, 5, 1, counter_width=3, device="cpu")
    # past 2**32 counters the port refuses, as the JAX package does; at
    # exactly 2**32 the positions take the wide form
    big = counting.CountingBloomFilter(
        counters=torch.zeros(1, dtype=torch.int32), size=(1 << 32) + 4,
        hash_num=1, kmer_size=5, count_threshold=1, counter_width=4)
    one = u64.from_numpy(np.zeros((1, 1), np.uint64))
    for fn in (counting.insert, counting.insert_all, counting.contains):
        with pytest.raises(ValueError):
            fn(big, one)
    exact = dataclasses.replace(big, size=1 << 32)
    assert counting._positions(exact, one).dtype == torch.int64


# ---------------------------------------------------------------------------
# .bf files
# ---------------------------------------------------------------------------

def insert_string(cbf, seq):
    return counting.insert_seq(cbf, nthash_tables.encode_seq(seq))


def test_cbf_golden_bytes(tmp_path):
    """The three golden counting .bf files, built by the port to the
    recipes of the JAX package's tests."""
    small = counting.create(1000, 5, 8, 1, counter_width=1, device="cpu")
    for _ in range(3):
        insert_string(small, CBF_SEQ)
    rnd = counting.create(1001, 4, 6, 2, counter_width=1, device="cpu")
    insert_string(rnd, golden_long_seq(300)[:100])
    c64 = counting.create(4096, 3, 5, 1, counter_width=8, device="cpu")
    insert_string(c64, golden_long_seq(300)[:120])
    for cbf, name in ((small, "cbf_small.bf"), (rnd, "cbf_round.bf"),
                      (c64, "cbf64_small.bf")):
        path = tmp_path / name
        bf_format.store_counting(cbf, str(path))
        assert path.read_bytes() == golden_bytes(name), name


def test_cbf_golden_load_and_query(tmp_path):
    path = tmp_path / "g.bf"
    path.write_bytes(golden_bytes("cbf_small.bf"))
    cbf = bf_format.load_counting(str(path), count_threshold=2, device="cpu")
    assert (cbf.size, cbf.hash_num, cbf.kmer_size, cbf.counter_width) == \
        (1000, 5, 8, 1)
    mc, valid = counting.min_count_seq(cbf, nthash_tables.encode_seq(CBF_SEQ))
    assert valid.all() and (mc == 3).all()      # every k-mer went in 3 times
    hit, _ = counting.contains_seq(cbf, nthash_tables.encode_seq(CBF_SEQ))
    assert hit.all()
    jcbf = jax_bf_format.load_counting(str(path), count_threshold=2)
    pair(cbf, jcbf)


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_cbf_store_load_roundtrip_matches_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    hs = rng.integers(0, 1 << 64, size=(200, 3), dtype=np.uint64)
    cbf = counting.create(1000, 3, 7, 2, counter_width=width, device="cpu")
    counting.insert_all(cbf, u64.from_numpy(hs))
    path = tmp_path / "rt.bf"
    bf_format.store_counting(cbf, str(path))
    back = bf_format.load_counting(str(path), count_threshold=2, device="cpu")
    assert (back.size, back.counter_width, back.hash_num, back.kmer_size,
            back.count_threshold) == (cbf.size, width, 3, 7, 2)
    assert torch.equal(back.counters, cbf.counters)
    jcbf = jax_bf_format.load_counting(str(path), count_threshold=2)
    pair(cbf, jcbf)
    jpath = tmp_path / "jax.bf"
    jax_bf_format.store_counting(jcbf, str(jpath))
    assert jpath.read_bytes() == path.read_bytes()
    with pytest.raises(ValueError):
        bf_format.parse_header(path.read_bytes(), bf_format.BLOOM_MAGIC)
