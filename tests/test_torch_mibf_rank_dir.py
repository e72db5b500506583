"""The MIBF rank directory (``kernels/mibf_rank.rank_directory``, built by
``models/mibf.freeze``) and the lookup through it
(``rank_lookup_dir_plain``, the CUDA kernel's arithmetic in torch) against
the plain lookup from ``bv_words`` / ``cum_ranks`` and against the JAX
package's ``rank_of_positions_kernel`` / ``rank_data_of_positions_kernel``,
whose Pallas gathers run in interpret mode, at sizes around the
directory's 7-word block.

Inputs are made with numpy from fixed seeds and handed to both sides. Every
output is an integer or a bool, so the tolerance is zero.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.kernels import gather_words as jax_gather_words
from btl_bloomfilter_tpu.models import mibf as jax_mibf
from btl_bloomfilter_tpu_torch.kernels import mibf_rank
from btl_bloomfilter_tpu_torch.models import mibf

torch.set_num_threads(1)

NP_DTYPE = {1: np.uint8, 2: np.uint16, 4: np.uint32}
SIZES = [1, 6, 7, 8, 13, 37]    # words: one block, its edges, not multiples


@pytest.fixture
def interpret():
    """The JAX package's Pallas gathers in interpret mode."""
    pair, single = (jax_gather_words.gather_words_pair_sorted,
                    jax_gather_words.gather_words_sorted)
    jax_gather_words.gather_words_pair_sorted = functools.partial(
        pair, interpret=True)
    jax_gather_words.gather_words_sorted = functools.partial(
        single, interpret=True)
    yield
    jax_gather_words.gather_words_pair_sorted = pair
    jax_gather_words.gather_words_sorted = single


def filters(nwords, width, seed):
    """(JAX filter, the port's copy of it) over random words with an empty
    and a full word among them, and a random ID plane."""
    rng = np.random.default_rng(seed)
    bv = rng.integers(0, 1 << 32, size=nwords, dtype=np.uint32)
    bv[rng.integers(0, nwords)] = 0
    bv[rng.integers(0, nwords)] = 0xFFFFFFFF
    jm = jax_mibf.freeze(jnp.asarray(bv), nwords * 32, hash_num=4,
                         kmer_size=21, data_width=width)
    data = rng.integers(0, 1 << (8 * width), size=jm.d_size,
                        dtype=np.uint64).astype(NP_DTYPE[width])
    jm = dataclasses.replace(jm, data=jnp.asarray(data))
    m = mibf.from_numpy(bv, data, size=jm.size, hash_num=4, kmer_size=21,
                        data_width=width, device="cpu")
    return jm, m


def positions(nwords, seed, past=0):
    """Random bit positions, every bit of the first and last words, and
    ``past`` positions past the vector (uint32)."""
    rng = np.random.default_rng(seed)
    last = nwords * 32
    return np.concatenate([
        rng.integers(0, last, size=3000, dtype=np.uint64),
        np.arange(32), np.arange(last - 32, last),
        rng.integers(last, 1 << 32, size=past, dtype=np.uint64),
    ]).astype(np.uint32)


def numpy_directory(bv, cum):
    """The directory's layout written out: per 7 words, the first word's
    cumulative count and the 7 words, zero past the vector."""
    nb = -(-bv.size // 7)
    words = np.zeros(nb * 7, np.uint32)
    words[:bv.size] = bv
    return np.concatenate([cum[::7, None], words.reshape(nb, 7)],
                          1).reshape(-1)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("nwords", SIZES)
def test_directory_lookup_matches_plain_and_jax_kernels(interpret, nwords,
                                                         width):
    jm, m = filters(nwords, width, 10 * nwords + width)
    pos = positions(nwords, nwords)
    jr, jh, jraw, over = jax.jit(jax_mibf.rank_data_of_positions_kernel)(
        jm, jnp.asarray(pos))
    jr2, jh2, over2 = jax.jit(jax_mibf.rank_of_positions_kernel)(
        jm, jnp.asarray(pos))
    assert int(over) == 0 and int(over2) == 0
    tpos = torch.from_numpy(pos.view(np.int32))
    via_dir = mibf_rank.rank_lookup_dir_plain(m.rank_dir, nwords, tpos,
                                              m.data)
    plain = mibf_rank.rank_lookup_plain(m.bv_words, m.cum_ranks, m.rank_dir,
                                        tpos, m.data)
    for got, ref in zip(via_dir, plain):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    np.testing.assert_array_equal(via_dir[0].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(via_dir[1].numpy(), np.asarray(jh))
    np.testing.assert_array_equal(via_dir[2].numpy().view(np.uint32),
                                  np.asarray(jraw))
    np.testing.assert_array_equal(via_dir[0].numpy(), np.asarray(jr2))
    np.testing.assert_array_equal(via_dir[1].numpy(), np.asarray(jh2))
    rank_only = mibf_rank.rank_lookup_dir_plain(m.rank_dir, nwords, tpos)
    assert rank_only[2] is None and torch.equal(rank_only[0], plain[0])


@pytest.mark.parametrize("nwords", SIZES + [1 << 16])
def test_directory_lookup_clamps_past_the_vector(nwords):
    """A word index past the vector reads its last word, through the
    directory as through the two arrays."""
    _, m = filters(nwords, 2, nwords + 1)
    tpos = torch.from_numpy(positions(nwords, 3, past=500).view(np.int32))
    via_dir = mibf_rank.rank_lookup_dir_plain(m.rank_dir, nwords, tpos,
                                              m.data)
    plain = mibf_rank.rank_lookup_plain(m.bv_words, m.cum_ranks, m.rank_dir,
                                        tpos, m.data)
    for got, ref in zip(via_dir, plain):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("nwords", SIZES + [1 << 16])
def test_directory_of_a_filter_carried_from_jax(nwords):
    """A filter carried from the JAX package's state gets the directory of
    the layout's definition, the same as freeze of the same words."""
    jm, m = filters(nwords, 2, nwords)
    bv, cum = np.array(jm.bv_words), np.array(jm.cum_ranks)
    np.testing.assert_array_equal(m.rank_dir.numpy().view(np.uint32),
                                  numpy_directory(bv, cum))
    fresh = mibf.freeze(torch.from_numpy(bv.view(np.int32)), nwords * 32, 4,
                        21)
    assert torch.equal(fresh.rank_dir, m.rank_dir)
    assert m.rank_dir.numel() == 8 * -(-nwords // 7)


def test_rank_lookup_refuses_ranks_past_int32():
    """An ID plane of 2**31 entries would need ranks past int32 (a
    broadcast view: nothing is allocated); a directory of another vector
    is refused too."""
    _, m = filters(13, 1, 0)
    pos = torch.zeros(4, dtype=torch.int32)
    big = torch.zeros(1, dtype=torch.uint8).expand(1 << 31)
    for fn in (mibf_rank.rank_lookup, mibf_rank.rank_lookup_plain):
        with pytest.raises(ValueError, match=r"2\*\*31"):
            fn(m.bv_words, m.cum_ranks, m.rank_dir, pos, big)
        with pytest.raises(ValueError, match="rank directory"):
            fn(m.bv_words, m.cum_ranks, m.rank_dir[:-8], pos)
