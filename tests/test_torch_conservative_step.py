"""The port's conservative step (``kernels/conservative_step``, plain
version) against the JAX package's closed form ``_closed_form_add`` and its
per-frame ``_make_word_step`` (the c = 1 case), at counter widths 1, 2 and
4.

Inputs are made with numpy from fixed seeds and handed to both sides:
position-disjoint frames with in-frame duplicate slots, sentinel frames,
words preloaded so that some frames sit frozen at counter_max and others
have less headroom than their repeat count c. The JAX closed form takes the
frames with their slots sorted, as its decomposition hands them over; the
port takes them in their original slot order. Outputs are packed words,
compared bitwise: the tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import counting as jax_counting
from btl_bloomfilter_tpu_torch.kernels import conservative_step as cs

torch.set_num_threads(1)

SENT = 0xFFFFFFFF
SHIFT = {1: 2, 2: 1, 4: 0}
LANE = {1: np.uint8, 2: np.uint16, 4: np.uint32}


@functools.partial(jax.jit, static_argnums=(4, 5))
def jax_closed_form(words, ks, c, closed, counter_max, per):
    cur = jax_counting._gather_lane_xla(
        words, jnp.where(closed[:, None], ks, 0), per)
    return jax_counting._closed_form_add(words, cur, ks, c, closed,
                                         counter_max, per)


@functools.partial(jax.jit, static_argnums=(3, 4))
def jax_word_steps(words, pos, ok, per, counter_max):
    out, _ = jax.lax.scan(jax_counting._make_word_step(per, counter_max),
                          words, (pos, ok))
    return out


def make_step_inputs(width, h, m, nwords, seed):
    """(words uint32 [nwords], pos uint32 [m, h], live bool [m], c int64
    [m]): live frames own disjoint sets of 1..h counters, their other slots
    repeat them; dead frames hold the sentinel in every slot."""
    rng = np.random.default_rng(seed)
    per = 4 // width
    cmax = (1 << (8 * width)) - 1
    ncount = nwords * per
    perm = rng.permutation(ncount)
    pos = np.full((m, h), SENT, np.uint32)
    live = rng.random(m) < 0.8
    vals = rng.integers(0, cmax + 1, size=ncount, dtype=np.uint64)
    at = 0
    for f in np.flatnonzero(live):
        k = int(rng.integers(1, h + 1))
        if at + k > ncount:
            live[f] = False
            continue
        own = perm[at:at + k]
        at += k
        slots = np.concatenate([own, rng.choice(own, h - k)])
        rng.shuffle(slots)
        pos[f] = slots
        kind = rng.random()
        if kind < 0.2:                       # frozen at counter_max
            vals[own] = cmax
        elif kind < 0.4:                     # less headroom than c
            vals[own] = cmax - rng.integers(0, 5, size=k)
    c = rng.choice(np.array([1, 2, 3, 7, 255, 300, 65535, 70000,
                             (1 << 31) - 1], np.int64), size=m)
    words = vals.astype(LANE[width]).view("<u4").astype(np.uint32)
    return words, pos, live, c


def port_step(words, pos, c, width):
    w = torch.from_numpy(words.view(np.int32).copy())
    p = torch.from_numpy(np.ascontiguousarray(pos.T).view(np.int32))
    cs.conservative_step_plain(w, p, torch.from_numpy(c), SHIFT[width],
                               (1 << (8 * width)) - 1)
    return w.numpy().view(np.uint32)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("h,m,nwords,seed", [
    (1, 300, 64, 1), (4, 500, 256, 2), (7, 200, 100, 3), (10, 150, 512, 4)])
def test_conservative_step_plain_matches_jax_closed_form(width, h, m,
                                                         nwords, seed):
    words, pos, live, c = make_step_inputs(width, h, m, nwords, seed)
    assert live.any() and (~live).any()
    ref = jax_closed_form(jnp.asarray(words), jnp.asarray(np.sort(pos, 1)),
                          jnp.asarray(c.astype(np.int32)), jnp.asarray(live),
                          (1 << (8 * width)) - 1, 4 // width)
    got = port_step(words, pos, c, width)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert not np.array_equal(got, words)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("h,m,nwords,seed", [(1, 100, 16, 5),
                                             (4, 200, 128, 6),
                                             (7, 120, 64, 7)])
def test_conservative_step_plain_matches_jax_word_step(width, h, m, nwords,
                                                       seed):
    """c = 1: one incrementMin per frame. The frames are position-disjoint,
    so the JAX per-frame scan and one batched step agree."""
    words, pos, live, _ = make_step_inputs(width, h, m, nwords, seed)
    ref = jax_word_steps(jnp.asarray(words),
                         jnp.asarray(np.where(live[:, None], pos, 0)),
                         jnp.asarray(live), 4 // width,
                         (1 << (8 * width)) - 1)
    got = port_step(words, pos, np.ones(m, np.int64), width)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_conservative_step_slot0_sentinel_writes_nothing():
    """A frame whose slot 0 is the sentinel is dead, whatever its other
    slots hold; a sentinel slot of a live frame reads 0 and writes
    nothing."""
    words = torch.tensor([0x05050505, 0x01020304], dtype=torch.int32)
    pos = torch.tensor([[-1, 4], [0, -1], [1, 7]], dtype=torch.int32)
    c = torch.tensor([9, 2], dtype=torch.int64)
    cs.conservative_step(words, pos, c, 2, 255)
    # frame 1: lanes 4 (4) and 7 (1) plus a sentinel slot reading 0, so
    # mn = 0 and target 2: lane 7 rises to 2, lane 4 stays
    assert words.tolist() == [0x05050505, 0x02020304]


def test_conservative_step_checks_inputs():
    words = torch.zeros(4, dtype=torch.int32)
    pos = torch.zeros((3, 5), dtype=torch.int32)
    c = torch.ones(5, dtype=torch.int64)
    before = cs.KERNEL.launches
    cs.conservative_step(words, pos, c, 2, 255)       # CPU: plain version
    assert cs.KERNEL.launches == before
    wide_before = cs.WIDE_KERNEL.launches
    cs.conservative_step(words, pos.long(), c, 2, 255)  # wide positions
    assert cs.WIDE_KERNEL.launches == wide_before
    with pytest.raises(TypeError):
        cs.conservative_step(words, pos.short(), c, 2, 255)
    with pytest.raises(TypeError):
        cs.conservative_step(words, pos, c.int(), 2, 255)
    with pytest.raises(TypeError):
        cs.conservative_step(words, pos, c[:4], 2, 255)
    with pytest.raises(ValueError):
        cs.conservative_step(words, pos, c, 3, 255)
    with pytest.raises(ValueError):
        cs.conservative_step(words, pos, c, 2, 256)
    with pytest.raises(ValueError):
        cs.conservative_step(words, pos[:0], c, 2, 255)
