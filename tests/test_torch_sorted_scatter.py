"""The port's sorted scatter-OR, in place (``kernels/scatter_or.py:
scatter_or_sorted``) and into a delta (``kernels/scatter_ring.py:
scatter_or_sorted``), plain PyTorch path, against the JAX package's Pallas
kernels of the same names run in interpret mode.

The cases are those of ``tests/test_scatter_kernel.py`` and
``tests/test_scatter_ring_kernel.py``. Where the JAX kernel's window
overflows, it is held after its own documented re-apply (the XLA scatter
over its partial result, as those tests do); the port applies every
position and reports overflow 0. Inputs are made with numpy from fixed
seeds; the outputs are integers, so the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.kernels import scatter_or as jax_scatter_or
from btl_bloomfilter_tpu.kernels import scatter_ring as jax_scatter_ring
from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu_torch.kernels import scatter_or, scatter_ring

torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)
CHUNK = jax_scatter_or.CHUNK
WIN_BITS = jax_scatter_or.WIN_WORDS * 32
assert WIN_BITS == jax_scatter_ring.NWIN * jax_scatter_ring.SLOT_WORDS * 32

# name: (jax function, port function, port updates words in place)
FORMS = {
    "in_place": (jax_scatter_or.scatter_or_sorted,
                 scatter_or.scatter_or_sorted, True),
    "delta": (jax_scatter_ring.scatter_or_sorted,
              scatter_ring.scatter_or_sorted, False),
}


@jax.jit
def xla_reference(words, pos_sorted):
    """The JAX package's re-apply: the XLA scatter of the deduplicated
    sorted positions."""
    keep = jnp.ones(pos_sorted.shape, bool).at[1:].set(
        pos_sorted[1:] != pos_sorted[:-1])
    keep = keep & (pos_sorted != jnp.uint32(SENT))
    return words | jax_bloom.sorted_delta_words(pos_sorted, keep,
                                                words.shape[0])


def dedup_sorted(pos, pad_to=None):
    pos = np.sort(pos)
    keep = np.ones(len(pos), bool)
    keep[1:] = pos[1:] != pos[:-1]
    out = np.full(pad_to if pad_to is not None else len(pos), SENT,
                  np.uint32)
    out[: keep.sum()] = pos[keep]
    return out


def random_case(n, size_bits, seed):
    rng = np.random.default_rng(seed)
    pos = dedup_sorted(rng.integers(0, size_bits, size=n, dtype=np.uint32))
    return size_bits // 32, pos, None, rng


def in_place_sentinels(seed=7):
    """Duplicates replaced by sentinels in place, window bases from the
    sorted array before the dedupe (pos_for_base)."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, WIN_BITS, size=4096, dtype=np.uint32)
    raw[50:60] = raw[49]                      # a duplicate run
    raw[1024:1030] = raw[1023]                # a run across a chunk edge
    pos_s = np.sort(raw)
    keep = np.ones(len(pos_s), bool)
    keep[1:] = pos_s[1:] != pos_s[:-1]
    return WIN_BITS // 32, np.where(keep, pos_s, SENT), pos_s, rng


def trailing_sentinel_chunks(seed=17):
    rng = np.random.default_rng(seed)
    live = rng.integers(0, WIN_BITS, size=500, dtype=np.uint32)
    return (WIN_BITS * 2 // 32, dedup_sorted(live, pad_to=4 * CHUNK), None,
            rng)


def overflow_case(seed=0):
    """Two clusters far apart in one chunk: the TPU window overflows."""
    nwords = jax_scatter_or.WIN_WORDS * 8
    pos = dedup_sorted(np.concatenate([
        np.arange(100, dtype=np.uint32),
        np.arange(nwords * 32 - 100, nwords * 32, dtype=np.uint32)]))
    return nwords, pos, None, np.random.default_rng(seed)


def tile_straddle(seed=11):
    """Positions on each side of every 64 KiB window edge of a 4-window
    filter, where the kernel's tiles meet."""
    rng = np.random.default_rng(seed)
    edges = np.arange(1, 4, dtype=np.int64) * WIN_BITS
    pos = np.concatenate([(edges[:, None] + np.arange(-400, 400)).ravel(),
                          rng.integers(0, 4 * WIN_BITS, size=1500)])
    return 4 * WIN_BITS // 32, dedup_sorted(pos.astype(np.uint32)), None, rng


CASES = {
    "uniform": lambda: random_case(2000, WIN_BITS * 4, 0),
    "one_window": lambda: random_case(5000, WIN_BITS, 1),
    "sparse": lambda: random_case(700, WIN_BITS * 8, 2),
    "unaligned_nwords": lambda: random_case(900, WIN_BITS + 64 * 37, 3),
    "tiny_filter": lambda: random_case(300, 64 * 11, 4),
    "chunk_multiple_unaligned": lambda: random_case(4096,
                                                    WIN_BITS * 2 + 64 * 5, 5),
    "in_place_sentinels": in_place_sentinels,
    "trailing_sentinel_chunks": trailing_sentinel_chunks,
    "overflow": overflow_case,
    "tile_straddle": tile_straddle,
    "three_windows_tail": lambda: random_case(3000,
                                              WIN_BITS * 3 + 32 * 1001, 6),
}


def as_i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)
                            .copy())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_sorted_scatter_matches_jax(form, case):
    jax_fn, port_fn, in_place = FORMS[form]
    nwords, pos, base, rng = CASES[case]()
    words = rng.integers(0, 1 << 32, size=nwords, dtype=np.uint32)
    got, over = jax_fn(jnp.asarray(words), jnp.asarray(pos),
                       pos_for_base=None if base is None
                       else jnp.asarray(base), interpret=True)
    if case == "overflow":
        assert int(over) > 0
    if int(over):
        got = xla_reference(got, jnp.asarray(pos))
    w = as_i32(words)
    out, p_over = port_fn(w, as_i32(pos),
                          pos_for_base=None if base is None else as_i32(base))
    assert p_over == 0
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(got))
    if in_place:
        assert out is w
    else:
        np.testing.assert_array_equal(w.numpy().view(np.uint32), words)


def test_sorted_scatter_any_order_and_past_filter():
    """Unsorted positions, duplicates, sentinels and words past the filter:
    both forms equal the unsorted insert (``scatter_or``)."""
    rng = np.random.default_rng(9)
    nwords = 333
    pos = rng.integers(0, nwords * 32 + 200, size=3000, dtype=np.uint64)
    pos[rng.random(3000) < 0.1] = SENT
    pos = as_i32(pos.astype(np.uint32))
    start = as_i32(rng.integers(0, 1 << 32, size=nwords, dtype=np.uint32))
    ref = scatter_or.scatter_or(start.clone(), pos)
    for _, port_fn, _ in FORMS.values():
        out, over = port_fn(start.clone(), pos)
        assert over == 0 and torch.equal(out, ref)
