"""The port's counting Bloom filter at exactly 2**32 counters, on the CPU:
the wide position form (int64, sentinel -1) that such a filter takes, held
against the narrow form (int32 holding uint32 bits, sentinel 0xFFFFFFFF)
and against the JAX package at small sizes for every counter width; the
whole wide path (positions, conservative steps, incrementAll) with the
wide form forced at small sizes; the modulo and pair-key arithmetic on
positions 2**32 - 1 and 2**32 - 2 and on the sentinel; and the refusal of
sizes past 2**32. A 2**32-counter filter takes 4 GiB or more, so it runs
only on the card (``chip_smoke.py`` phase 14).

Inputs are made with numpy from fixed seeds; every compared output is an
integer or a bool, so the tolerance is zero.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import counting as jax_counting
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.kernels import nthash_scan
from btl_bloomfilter_tpu_torch.models import counting
from btl_bloomfilter_tpu_torch.ops import u64
from btl_bloomfilter_tpu_torch.ops.replay import (STREAM_BITS, STREAM_MASK,
                                                  replay_depth)

torch.set_num_threads(1)

S = 1 << 32
WIDTHS = [1, 2, 4, 8]

jax_insert = jax.jit(jax_counting.insert,
                     static_argnames=("max_entangled", "group_duplicates"))
jax_insert_all = jax.jit(jax_counting.insert_all)
jax_min_count = jax.jit(jax_counting.min_count)
jax_contains = jax.jit(jax_counting.contains)


def stream(n, h, seed, repeat=2, vfrac=0.85):
    """Random frames, each repeated ``repeat`` times in a shuffled order,
    and a valid mask."""
    r = np.random.default_rng(seed)
    hs = r.integers(0, 1 << 64, size=(n, h), dtype=np.uint64)
    idx = np.tile(np.arange(n), repeat)
    r.shuffle(idx)
    return hs[idx], r.random(n * repeat) < vfrac


def planes(hashes, valid, size, wide):
    """Position planes [h, n] of frames hashes [n, h]: the narrow form
    (int32, 0xFFFFFFFF) or the wide one (int64, -1) in every slot of an
    invalid frame."""
    p = (hashes % np.uint64(size)).astype(np.int64).T
    p = np.where(valid[None, :], p, -1)
    return torch.from_numpy(p if wide else p.astype(np.int32))


def same(cbf, jcbf):
    np.testing.assert_array_equal(counting.to_numpy(cbf),
                                  jax_counting.to_numpy(jcbf))


@pytest.mark.parametrize("group", [True, False])
@pytest.mark.parametrize("width", WIDTHS)
def test_sentinel_forms_match_each_other_and_jax(width, group):
    """insert / min count / contains of position planes: the narrow and
    the wide form give the JAX package's counters and answers."""
    size_bytes, h, k, thr = 1024, 4, 5, 2
    hashes, valid = stream(700, h, seed=width)
    jcbf = jax_insert(jax_counting.create(size_bytes, h, k, thr, width),
                      jax_u64.from_numpy(hashes), valid,
                      group_duplicates=group)
    probe, pvalid = stream(300, h, seed=10 + width, repeat=1)
    probe[:200] = hashes[:200]
    jmc = jax_min_count(jcbf, jax_u64.from_numpy(probe))
    jmc = (jmc.astype_numpy() if width == 8
           else np.asarray(jmc).astype(np.uint64))
    jhit = np.asarray(jax_contains(jcbf, jax_u64.from_numpy(probe)))
    for wide in (False, True):
        cbf = counting.create(size_bytes, h, k, thr, width, device="cpu")
        counting.insert_sentinel_positions(
            cbf, planes(hashes, valid, cbf.size, wide),
            group_duplicates=group)
        same(cbf, jcbf)
        pp = planes(probe, pvalid, cbf.size, wide)
        mc = counting.min_count_sentinel_positions(cbf, pp)
        hit = counting.contains_sentinel_positions(cbf, pp)
        mc = u64.to_numpy(mc)
        np.testing.assert_array_equal(mc[pvalid], jmc[pvalid])
        assert (mc[~pvalid] == 0).all()
        np.testing.assert_array_equal(hit.numpy(), jhit & pvalid)


@pytest.mark.parametrize("width", WIDTHS)
def test_wide_path_matches_jax(width, monkeypatch):
    """Every size forced onto the wide form (the one a 2**32-counter filter
    takes): the hashes' positions, the conservative steps, incrementAll
    and the queries give the JAX package's counters and answers."""
    monkeypatch.setattr(nthash_scan, "WIDE_SIZE", 1)
    size_bytes, h, k, thr = 4096, 3, 5, 1
    hashes, valid = stream(900, h, seed=20 + width, repeat=3)
    cbf = counting.create(size_bytes, h, k, thr, width, device="cpu")
    assert counting._positions(cbf, u64.from_numpy(hashes)).dtype == \
        torch.int64
    jh = jax_u64.from_numpy(hashes)
    for group in (True, False):
        jcbf = jax_insert(jax_counting.create(size_bytes, h, k, thr, width),
                          jh, valid, group_duplicates=group)
        cbf = counting.create(size_bytes, h, k, thr, width, device="cpu")
        counting.insert(cbf, u64.from_numpy(hashes), torch.from_numpy(valid),
                        group_duplicates=group)
        same(cbf, jcbf)
    np.testing.assert_array_equal(
        counting.contains(cbf, u64.from_numpy(hashes)).numpy(),
        np.asarray(jax_contains(jcbf, jh)))
    jcbf = jax_insert_all(jcbf, jh, valid)
    counting.insert_all(cbf, u64.from_numpy(hashes), torch.from_numpy(valid))
    same(cbf, jcbf)


def test_modulo_and_pair_keys_at_2_32():
    """Positions 2**32 - 1 and 2**32 - 2 are real counters of a 2**32
    filter: the modulo keeps them, the decomposition's (position, frame)
    key carries them and the sentinel -1 apart, and the decomposition and
    replay schedule treat them as any other position."""
    h64 = np.array([S - 1, S - 2, 2 * S - 1, (1 << 64) - 1, S, 0,
                    (1 << 64) - 2], np.uint64)
    np.testing.assert_array_equal(
        u64.mod_const(u64.from_numpy(h64), S).numpy(),
        (h64 % np.uint64(S)).astype(np.int64))
    fake = counting.CountingBloomFilter(
        counters=torch.zeros(1, dtype=torch.int32), size=S, hash_num=2,
        kmer_size=5, count_threshold=1, counter_width=1)
    frames = np.array([[S - 1, S - 2], [2 * S - 1, 5], [7, 8],
                       [S - 2, (1 << 64) - 7], [10, 11]], np.uint64)
    valid = torch.tensor([True, True, False, True, True])
    pos = counting._frames(fake, u64.from_numpy(frames), valid)
    assert pos.dtype == torch.int64
    assert pos.T.tolist() == [[S - 1, S - 2], [S - 1, 5], [-1, -1],
                              [S - 2, ((1 << 64) - 7) % S], [10, 11]]
    frame = torch.arange(5).repeat(2)
    key = (pos.reshape(-1) << STREAM_BITS) | frame
    assert torch.equal(key >> STREAM_BITS, pos.reshape(-1))
    assert torch.equal(key & STREAM_MASK, frame)
    order = torch.sort(key).values >> STREAM_BITS
    assert order.tolist() == sorted(pos.reshape(-1).tolist())  # -1 first
    for group in (True, False):
        ks, closed, closed_c, ent = counting._decompose(pos, group)
        # frame 0 is the first user of 2**32 - 1 and of 2**32 - 2: closed
        # form; frames 1 and 3 share one of them later: replay; frame 4
        # shares nothing: closed form; frame 2 is invalid
        assert ent.tolist() == [1, 3]
        live_closed = ks[:, closed]
        assert sorted(map(sorted, live_closed.T.tolist())) == [
            [10, 11], [S - 2, S - 1]]
    assert replay_depth(pos[:, [0, 1, 3]]).tolist() == [1, 2, 2]


def test_sizes_past_2_32_raise():
    big = counting.CountingBloomFilter(
        counters=torch.zeros(1, dtype=torch.int32), size=S + 4, hash_num=1,
        kmer_size=5, count_threshold=1, counter_width=4)
    one = u64.from_numpy(np.zeros((1, 1), np.uint64))
    pos = torch.zeros((1, 1), dtype=torch.int64)
    for fn, arg in ((counting.insert, one), (counting.insert_all, one),
                    (counting.contains, one), (counting.min_count, one),
                    (counting.insert_sequential, one),
                    (counting.min_count_sentinel_positions, pos),
                    (counting.contains_sentinel_positions, pos),
                    (counting.insert_sentinel_positions, pos),
                    (counting.insert_seq, np.zeros((1, 9), np.uint8))):
        with pytest.raises(ValueError):
            fn(big, arg)
    exact = dataclasses.replace(big, size=S)
    assert counting._positions(exact, one).dtype == torch.int64
