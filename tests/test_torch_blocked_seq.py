"""The blocked filter's sequence insert (``blocked.insert_seq``, on the CPU
its plain path: ntHash's hash mode, then the plain insert) against the JAX
package's ``blocked.insert`` / ``contains`` of the JAX hashes: the rows
after the insert, after the same batch inserted again, and the hits of
``contains_seq``, on reads the fused kernel treats specially (poly-A and
poly-T reads, whose windows share one canonical hash; a tandem repeat;
reads shorter than k, padded with N; all-N reads; random reads with N), at
k = 31 and 129, h = 1, 4 and 17, in filters whose block count is and is not
a power of two.

Inputs are made with numpy from fixed seeds; rows and hits are integers and
bools, so the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.models import blocked as jax_blocked
from btl_bloomfilter_tpu.ops import nthash as jax_nthash
from btl_bloomfilter_tpu.ops import u64 as jax_u64
from btl_bloomfilter_tpu_torch.models import blocked

torch.set_num_threads(1)

jax_insert = jax.jit(jax_blocked.insert)
jax_contains = jax.jit(jax_blocked.contains)
jax_hash_frames = jax.jit(jax_nthash.hash_frames, static_argnums=(1, 2))

B, L = 6, 300
POW2, ODD = 1 << 16, (1 << 16) + 3 * 512      # 128 and 131 blocks


def reads(kind: str, k: int, seed: int) -> np.ndarray:
    """B x L codes of one kind; "mixed" holds one read of every kind."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    polya = np.zeros(L, np.uint8)
    tandem = np.tile(np.array([0, 1, 1, 3, 2], np.uint8), L)[:L]
    short = codes[0].copy()
    short[k - 1:] = 4                  # a read of k - 1 bases, padded
    every = {"polyA": polya, "polyT": polya + 3, "tandem": tandem,
             "short": short, "allN": np.full(L, 4, np.uint8)}
    if kind == "mixed":
        for i, read in enumerate(every.values()):
            codes[i] = read
    else:
        codes[:] = every[kind]
    return codes


CASES = [  # kind, k, h, size
    ("polyA", 31, 4, POW2),
    ("polyA", 129, 17, ODD),
    ("polyT", 31, 1, ODD),
    ("tandem", 129, 4, POW2),
    ("short", 31, 17, ODD),
    ("short", 129, 1, POW2),
    ("allN", 31, 4, ODD),
    ("allN", 129, 17, POW2),
    ("mixed", 31, 4, ODD),
    ("mixed", 31, 17, POW2),
    ("mixed", 129, 4, ODD),
    ("mixed", 129, 1, POW2),
]


@pytest.mark.parametrize("kind,k,h,size", CASES)
def test_insert_seq_matches_jax(kind, k, h, size):
    codes = reads(kind, k, seed=k * 100 + h)
    jf = jax_hash_frames(jnp.asarray(codes), k, 1)
    canon = jax_u64.U64(jf.hashes.hi[..., 0], jf.hashes.lo[..., 0])
    jbf = jax_blocked.create(size, h, k)
    bf = blocked.create(size, h, k, device="cpu")
    for _ in range(2):              # the second insert changes nothing
        jbf = jax_insert(jbf, canon, jf.valid)
        blocked.insert_seq(bf, codes)
        np.testing.assert_array_equal(blocked.to_numpy_rows(bf),
                                      np.asarray(jbf.rows))
    hit, valid = blocked.contains_seq(bf, codes)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jf.valid))
    np.testing.assert_array_equal(
        hit.numpy(), np.asarray(jax_contains(jbf, canon) & jf.valid))
    assert hit[valid].all()
    if kind == "allN":
        assert not valid.any() and not bf.rows.any()


def test_reads_shorter_than_k_raise():
    """A batch shorter than k has no window: both packages refuse it."""
    codes = reads("polyA", 31, 0)[:, :30]
    with pytest.raises(ValueError):
        jax_nthash.hash_frames(jnp.asarray(codes), 31, 1)
    with pytest.raises(ValueError):
        blocked.insert_seq(blocked.create(POW2, 4, 31, device="cpu"), codes)


# A 31-mer whose canonical hash, 0x1ce01498dc7fffff, picks the last block
# of a 2**32-bit filter (its low 23 bits all set) and, at h = 4, bit 511 of
# it (slot 1): the filter's bit 2**32 - 1.
LAST_BIT_KMER = "ACAAGCTGCGTTCCTCCCCTCCTCAACACCT"


def test_insert_seq_sets_bit_2_32_minus_1():
    """At exactly 2**32 bits the sequence insert sets the last bit (the
    JAX insert drops it as its uint32 sentinel) and the query finds it."""
    codes = np.array([["ACGT".index(b) for b in LAST_BIT_KMER]], np.uint8)
    jf = jax_hash_frames(jnp.asarray(codes), 31, 1)
    assert int(np.asarray(jf.hashes.hi)[0, 0, 0]) == 0x1ce01498
    assert int(np.asarray(jf.hashes.lo)[0, 0, 0]) == 0xdc7fffff
    bf = blocked.insert_seq(blocked.create(1 << 32, 4, 31, device="cpu"),
                            codes)
    assert int(bf.rows[-1, 15]) < 0                      # bit 31 set
    assert int((bf.rows != 0).sum()) <= 4
    hit, valid = blocked.contains_seq(bf, codes)
    assert bool(hit.all()) and bool(valid.all())
