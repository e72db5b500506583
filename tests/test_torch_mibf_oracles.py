"""The port's MIBF oracles against the JAX package: insertBVColli, batched
(``insert_bv_colli``) and frame by frame (``insert_bv_colli_sequential``),
and the per-frame classification engine ``query_scan`` /
``query_scan_batch``, also against the port's batched engine
``query_frames_batch`` on the adversarial frame tables of
tests/test_mibf_query.py (saturated values, raws repeated inside frames,
misses, invalid frames, early exits, out-of-range IDs).

Inputs are made with numpy from fixed seeds and handed to both sides; the
outputs are integers and bools, compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import mibf_construct as jax_construct
from btl_bloomfilter_tpu.models import mibf_query as jax_query
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.models import mibf, mibf_construct, mibf_query
from btl_bloomfilter_tpu_torch.ops import u64

from test_mibf import rand_hashes
from test_mibf_query import build_filter

torch.set_num_threads(1)

KEYS = ("counts", "candidates", "best", "sat_count", "eval_count")


def states(size, h, words=None):
    """(JAX, port) phase-1 states of ``size`` bits over ``words``."""
    w = np.zeros(size // 32, np.uint32) if words is None else words
    return (jax_construct.BitVectorState(
        bv_words=jnp.asarray(w), filter_size=size, kmer_size=9, hash_num=h,
        occupancy=0.5, sseeds=()),
        mibf_construct.BitVectorState(
            bv_words=torch.from_numpy(w.view(np.int32).copy()),
            filter_size=size, kmer_size=9, hash_num=h, occupancy=0.5,
            sseeds=()))


def colli_all(size, h, stream, valid=None, words=None):
    """insertBVColli of ``stream`` on both sides, batched and sequential:
    [(count, words uint32)] for JAX batched, JAX sequential, port batched,
    port sequential."""
    out = []
    jv = None if valid is None else jnp.asarray(valid)
    pv = None if valid is None else torch.from_numpy(valid)
    for fn in (jax_construct.insert_bv_colli,
               jax_construct.insert_bv_colli_sequential):
        st, count = fn(states(size, h, words)[0],
                       jax_u64.from_numpy(stream), jv)
        out.append((int(count), np.asarray(st.bv_words)))
    for fn in (mibf_construct.insert_bv_colli,
               mibf_construct.insert_bv_colli_sequential):
        st, count = fn(states(size, h, words)[1], u64.from_numpy(stream), pv)
        out.append((count, st.bv_words.numpy().view(np.uint32)))
    return out


def test_insert_bv_colli_matches_jax_and_model():
    """Re-inserted frames collide (tests/test_mibf.py's case), against a
    Python stream-order model."""
    size, h = 2048, 3
    hashes = rand_hashes(50, h, 21)
    dup = np.concatenate([hashes, hashes[:10]])
    bits = np.zeros(size, bool)
    expect = 0
    for row in dup:
        pos = (row % np.uint64(size)).astype(int)
        expect += bool(bits[pos].all())
        bits[pos] = True
    results = colli_all(size, h, dup)
    for count, words in results:
        assert count == expect
        np.testing.assert_array_equal(
            np.unpackbits(words.view(np.uint8), bitorder="little")[:size],
            bits)
    assert expect >= 10


@pytest.mark.parametrize("preset", [False, True])
def test_insert_bv_colli_batched_matches_sequential(preset):
    """Duplicate-heavy streams at varying distances with invalid frames
    mixed in, positions repeated inside one frame, and (``preset``) bits set
    before the batch: all four forms agree in count and words."""
    size, h = 1024, 3
    rng = np.random.default_rng(31)
    hashes = rand_hashes(120, h, 31)
    stream = np.concatenate([hashes[:40], hashes[10:50], hashes,
                             hashes[::3]])
    stream[7, 2] = stream[7, 0]                 # a frame's own repeat
    stream[60, 1] = stream[60, 0] + np.uint64(size)
    valid = rng.random(len(stream)) < 0.85
    words = (rng.integers(0, 1 << 32, size // 32, dtype=np.uint64)
             & rng.integers(0, 1 << 32, size // 32, dtype=np.uint64)
             ).astype(np.uint32) if preset else None
    results = colli_all(size, h, stream, valid, words)
    for count, w in results[1:]:
        assert count == results[0][0]
        np.testing.assert_array_equal(w, results[0][1])
    assert 0 < results[0][0] < int(valid.sum())


def adversarial_table(seed, R, W, h, num_ids, satfrac, missfrac, oor):
    """tests/test_mibf_query.py's frame tables: (m JAX, arrays)."""
    rng = np.random.default_rng(seed)
    m, _ = build_filter(size=1024, h=h, n=50, seed=seed)
    ids = rng.integers(0, num_ids, size=(R, W, h)).astype(np.uint32)
    if oor:
        alien = rng.random((R, W, h)) < 0.15
        ids = np.where(alien, ids + np.uint32(num_ids + 3), ids)
    sat = rng.random((R, W, h)) < satfrac
    raw = np.where(sat, ids | np.uint32(m.s_mask), ids)
    dup = rng.random((R, W)) < 0.3
    raw[dup, 1] = raw[dup, 0]
    hit = rng.random((R, W, h)) >= missfrac
    raw = np.where(hit, raw, 0)
    misses = (~hit).sum(axis=-1).astype(np.int32)
    valid = rng.random((R, W)) < 0.9
    usable = valid & (misses <= 1)
    mc = rng.integers(1, 4, size=num_ids).astype(np.int32)
    return m, (raw, hit, usable, misses, mc, valid)


def port_filter(jm):
    return mibf.from_numpy(np.asarray(jm.bv_words), np.asarray(jm.data),
                           size=jm.size, hash_num=jm.hash_num,
                           kmer_size=jm.kmer_size, data_width=jm.data_width,
                           device="cpu")


@pytest.mark.parametrize("seed,R,W,h,num_ids,efl,satfrac,missfrac,oor", [
    (1, 3, 40, 4, 8, 10**6, 0.2, 0.0, False),
    (2, 4, 57, 3, 8, 3, 0.3, 0.2, False),       # early exit + misses
    (3, 2, 33, 4, 5, 0, 0.5, 0.3, True),        # tiny efl + out-of-range
    (4, 5, 64, 2, 16, 7, 0.0, 0.0, False),
    (5, 1, 128, 4, 64, 10**6, 0.1, 0.1, False),
])
def test_query_scan_batch_matches_jax_and_engine(seed, R, W, h, num_ids,
                                                 efl, satfrac, missfrac, oor):
    jm, (raw, hit, usable, misses, mc, ev) = adversarial_table(
        seed, R, W, h, num_ids, satfrac, missfrac, oor)
    want = jax_query.query_scan_batch(
        jm, jnp.asarray(raw), jnp.asarray(hit), jnp.asarray(usable),
        jnp.asarray(misses), jnp.asarray(mc), num_ids, efl,
        frame_eval=jnp.asarray(ev))
    m = port_filter(jm)
    args = (m, torch.from_numpy(raw.astype(np.int64)), torch.from_numpy(hit),
            torch.from_numpy(usable), torch.from_numpy(misses),
            torch.from_numpy(mc), num_ids, efl)
    got = mibf_query.query_scan_batch(*args,
                                      frame_eval=torch.from_numpy(ev))
    engine = mibf_query.query_frames_batch(*args,
                                           frame_eval=torch.from_numpy(ev))
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(engine[k].numpy(), got[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("st_mode", [False, True])
def test_query_scan_one_read_matches_jax(st_mode):
    """One read through query_scan, with the default frame_eval of each
    mode (every valid frame in nt mode, none in st mode)."""
    jm, (raw, hit, usable, misses, mc, _) = adversarial_table(
        2, 1, 57, 3, 8, 0.3, 0.2, False)
    want = jax_query.query_scan(
        jm, jnp.asarray(raw[0]), jnp.asarray(hit[0]), jnp.asarray(usable[0]),
        jnp.asarray(misses[0]), jnp.asarray(mc), 8, 3, st_mode=st_mode)
    got = mibf_query.query_scan(
        port_filter(jm), torch.from_numpy(raw[0].astype(np.int64)),
        torch.from_numpy(hit[0]), torch.from_numpy(usable[0]),
        torch.from_numpy(misses[0]), torch.from_numpy(mc), 8, 3,
        st_mode=st_mode)
    for k in KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
