"""The port's spaced-seed hashing (``ops/seeds.py``, plain PyTorch) against
the reference's goldens and the JAX package, and the spaced-hash kernel's
arithmetic (the ntHash roll, the masked offsets' table rows and the seed
list, ``kernels/spaced_scan``) modelled against the plain version.

stHash: ``spaced_hash_frames`` against ``sthash_golden.jsonl`` and against
the JAX ``spaced_hash_frames`` on random reads with Ns (and other non-ACGT
codes) at k = 1, 9, 31 and 129 with 1-4 seeds and m2 = 1-3. ssHash:
``single_spaced_hash`` against ``sshash_golden.jsonl`` and the JAX
function, window-0 quirk included. Reads shorter than k and seeds of
unequal length raise in both packages. Every output is an integer or a
bool: the tolerance is zero.
"""

import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu.ops import seeds as jax_seeds
from btl_bloomfilter_tpu_torch.kernels import _build, nthash_scan, spaced_scan
from btl_bloomfilter_tpu_torch.ops import nthash, nthash_tables, seeds, u64
from test_torch_nthash_roll import roll_model

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def load_jsonl(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


ST_CASES = load_jsonl("sthash_golden.jsonl")
SS_CASES = load_jsonl("sshash_golden.jsonl")


def encoded(seq):
    return torch.from_numpy(nthash_tables.encode_seq(seq))


@pytest.mark.parametrize(
    "case", ST_CASES,
    ids=[f"k{c['k']}m{c['m']}x{c['m2']}L{len(c['seq'])}" for c in ST_CASES])
def test_sthash_matches_golden(case):
    f = seeds.spaced_hash_frames(encoded(case["seq"]), case["seeds"],
                                 case["m2"])
    hashes, strand = u64.to_numpy(f.hashes), f.strand.numpy()
    golden = {g["pos"]: g for g in case["frames"]}
    assert set(np.nonzero(f.valid.numpy())[0].tolist()) == set(golden)
    for pos, g in golden.items():
        np.testing.assert_array_equal(
            hashes[pos], np.array(g["hashes"], dtype=np.uint64))
        np.testing.assert_array_equal(strand[pos].astype(int), g["strand"])


@pytest.mark.parametrize(
    "case", SS_CASES,
    ids=[f"k{c['k']}L{len(c['seq'])}-{c['seed']}" for c in SS_CASES])
def test_sshash_matches_golden(case):
    sval = u64.to_numpy(seeds.single_spaced_hash(encoded(case["seq"]),
                                                 case["seed"]))
    golden = {g["pos"]: g["sval"] for g in case["frames"]}
    # the ssHashIterator yields every window position
    assert set(golden) == set(range(len(sval)))
    for pos, expect in golden.items():
        assert int(sval[pos]) == expect, pos


def random_seeds(k, m, rng):
    """m seeds of length k with a few '0' columns (none for k == 1)."""
    out = []
    for _ in range(m):
        s = np.array(list("1" * k))
        if k > 1:
            s[rng.choice(k, size=max(1, k // 5), replace=False)] = "0"
        out.append("".join(s))
    return out


def random_codes(B, L, seed, nfrac=0.03):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < nfrac] = 4
    codes[rng.random((B, L)) < nfrac / 3] = 200      # other non-ACGT codes
    return codes


def jax_frames(codes, seed_strings, m2):
    fn = jax.jit(functools.partial(jax_seeds.spaced_hash_frames,
                                   seed_strings=tuple(seed_strings), m2=m2))
    f = fn(codes)
    return f.hashes.astype_numpy(), np.asarray(f.strand), np.asarray(f.valid)


@pytest.mark.parametrize("k,m,m2,B,L", [
    (1, 1, 1, 2, 40),
    (9, 2, 3, 3, 120),
    (9, 4, 1, 2, 9),          # one window a read
    (31, 2, 2, 3, 200),
    (31, 3, 1, 2, 150),
    (129, 1, 2, 2, 300),
    (129, 4, 3, 1, 140),
])
def test_spaced_frames_match_jax(k, m, m2, B, L):
    rng = np.random.default_rng(k * 100 + m * 10 + m2)
    seed_strings = random_seeds(k, m, rng)
    codes = random_codes(B, L, k + m + m2)
    f = seeds.spaced_hash_frames(torch.from_numpy(codes), seed_strings, m2)
    h, st, v = jax_frames(codes, seed_strings, m2)
    np.testing.assert_array_equal(u64.to_numpy(f.hashes), h)
    np.testing.assert_array_equal(f.strand.numpy(), st)
    np.testing.assert_array_equal(f.valid.numpy(), v)
    assert f.hashes.shape == (B, L - k + 1, m * m2)
    # the kernel's wrapper on the CPU: the same frames as planes
    planes, strand, valid = spaced_scan.spaced_frames_planes(
        torch.from_numpy(codes), seed_strings, m2)
    assert torch.equal(planes.movedim(0, -1), f.hashes)
    assert torch.equal(strand.movedim(0, -1), f.strand)
    assert torch.equal(valid, f.valid)


@pytest.mark.parametrize("k,seed_string", [
    (1, "1"), (9, "110110111"), (9, "110110110"), (31, "1" * 15 + "0" * 16),
    (129, "10" * 64 + "1")])
def test_single_spaced_hash_matches_jax(k, seed_string):
    codes = random_codes(2, k + 60, k)
    got = seeds.single_spaced_hash(torch.from_numpy(codes), seed_string)
    fn = jax.jit(functools.partial(jax_seeds.single_spaced_hash,
                                   seed_string=seed_string))
    np.testing.assert_array_equal(u64.to_numpy(got),
                                  fn(codes).astype_numpy())


def test_reads_shorter_than_k_and_unequal_seeds_raise():
    codes = random_codes(2, 8, 0)
    with pytest.raises(ValueError):
        jax_seeds.spaced_hash_frames(codes, ["110110111"], 1)
    with pytest.raises(ValueError):
        seeds.spaced_hash_frames(torch.from_numpy(codes), ["110110111"], 1)
    with pytest.raises(ValueError):
        spaced_scan.spaced_frames_planes(torch.from_numpy(codes),
                                         ["110110111"], 1)
    long = random_codes(2, 30, 0)
    with pytest.raises(ValueError):
        jax_seeds.spaced_hash_frames(long, ["11011", "110111"], 1)
    with pytest.raises(ValueError):
        seeds.spaced_hash_frames(torch.from_numpy(long), ["11011", "110111"])
    with pytest.raises(ValueError):
        spaced_scan.spaced_frames_planes(torch.from_numpy(long),
                                         ["11011", "110111"], 1)


def test_padded_short_reads_hash_invalid():
    """A read shorter than k inside a batch (padded with N, as the
    pipelines pad) has no valid window; the others are unchanged."""
    k, seed_strings = 31, random_seeds(31, 2, np.random.default_rng(3))
    codes = random_codes(3, 100, 5, nfrac=0.0)
    codes[1, 20:] = nthash_tables.CODE_N
    f = seeds.spaced_hash_frames(torch.from_numpy(codes), seed_strings, 2)
    assert not f.valid[1].any() and f.valid[0].all() and f.valid[2].all()
    h, _, _ = jax_frames(codes, seed_strings, 2)
    np.testing.assert_array_equal(u64.to_numpy(f.hashes), h)


def kernel_model(codes, seed_strings, m2):
    """csrc/spaced_scan.cu's arithmetic: the unmasked hashes rolled in runs
    from the all-N window with the ntHash kernel's tables (the model of
    tests/test_torch_nthash_roll.py), then each seed's masked offsets XORed
    out again from their rows of ``masked_tables``, the bases at the
    offsets ``seed_info`` lists."""
    k = len(seed_strings[0])
    fh, rh, valid = roll_model(codes.numpy(), k, nthash_scan.run_length(k))
    fh, rh = u64.from_numpy(fh), u64.from_numpy(rh)
    rows = spaced_scan.masked_tables(tuple(seed_strings)).view(-1, 10)
    info = spaced_scan.seed_info(tuple(seed_strings)).tolist()
    m = len(seed_strings)
    win = codes.to(torch.int64).clamp(max=4).unfold(1, k, 1)   # [B, W, k]
    hashes, strands = [], []
    for s in range(m):
        fs, rs = fh.clone(), rh.clone()
        for z in range(info[s], info[s + 1]):
            c = win[..., info[m + 1 + z]]
            fs ^= rows[z][c]
            rs ^= rows[z][5 + c]
        st = u64.lt(rs, fs)
        d = nthash.derive_hashes(torch.where(st, rs, fs), k, m2)
        hashes.append(d)
        strands.append(st[..., None].expand(d.shape))
    return torch.cat(hashes, -1), torch.cat(strands, -1), \
        torch.from_numpy(valid)


@pytest.mark.parametrize("k,m,m2", [(1, 1, 2), (9, 2, 1), (31, 2, 2),
                                    (129, 3, 3), (700, 2, 1)])
def test_kernel_tables_model_matches_plain(k, m, m2):
    """The roll tables, the masked rows and the seed list the kernel reads
    give the plain frames: at k = 700 the rows of 2 x 140 masked offsets
    take 22 KB of shared memory."""
    seed_strings = random_seeds(k, m, np.random.default_rng(k))
    codes = torch.from_numpy(random_codes(2, k + 40, k))
    got = kernel_model(codes, seed_strings, m2)
    f = seeds.spaced_hash_frames(codes, seed_strings, m2)
    for a, b in zip(got, (f.hashes, f.strand, f.valid)):
        assert torch.equal(a, b)


def test_masked_tables_layout():
    """Each masked offset's row: its 5 forward then 5 reverse terms."""
    seed_strings = ("1101", "1111", "0110")
    k = 4
    tab = spaced_scan.offset_tables(k)
    rows = spaced_scan.masked_tables(seed_strings).view(-1, 10)
    assert rows.shape == (3, 10)
    for z, i in enumerate([2, 0, 3]):
        assert torch.equal(rows[z, :5], tab[5 * i: 5 * i + 5])
        assert torch.equal(rows[z, 5:], tab[5 * k + 5 * i: 5 * k + 5 * i + 5])
    assert spaced_scan.masked_tables(("111",)).numel() == 0


def test_tile_matches_the_source():
    """The wrapper's tile size is the kernel's (``#define TILE``)."""
    with open(os.path.join(_build.CSRC, "spaced_scan.cu")) as f:
        tile = re.search(r"^#define TILE (\d+)", f.read(), re.M).group(1)
    assert int(tile) == spaced_scan.TILE


def test_seed_info_layout():
    info = spaced_scan.seed_info(("1101", "1111", "0110"))
    assert info.tolist() == [0, 1, 1, 3, 2, 0, 3]
    assert seeds.parse_seed_strings(["1101", "0110"]) == [[2], [0, 3]]
