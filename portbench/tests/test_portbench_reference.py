"""The reference against the C++ goldens, the port's plain path and
hand-counted bytes."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.reference import bloom as ref_bloom
from portbench.reference import nthash

GOLDEN = os.path.join(ROOT, "tests", "golden")
U64 = (1 << 64) - 1


def _golden_lines(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("case", range(len(_golden_lines(
    "nthash_golden.jsonl"))))
def test_nthash_matches_cpp_iterator(case):
    d = _golden_lines("nthash_golden.jsonl")[case]
    seq, k, h = d["seq"], d["k"], d["h"]
    want = {f["pos"]: f["hashes"] for f in d["frames"]}
    if len(seq) < k:
        assert not want
        return
    codes = nthash.encode(seq)
    planes = torch.stack(list(nthash.hashes(nthash.canonical(codes, k), k,
                                            h)))
    valid = nthash.valid_windows(codes, k)[0]
    assert [p for p in range(valid.numel()) if valid[p]] == sorted(want)
    for p, hashes in want.items():
        assert [int(v) & U64 for v in planes[:, 0, p]] == hashes


def test_kmer_hashes_match_cpp():
    for d in _golden_lines("kmer_golden.jsonl"):
        k, h = d["k"], d["h"]
        canon = nthash.canonical(nthash.encode(d["kmer"]), k)
        got = [int(v[0, 0]) & U64 for v in nthash.hashes(canon, k, h)]
        assert got == d["hashes"], d["kmer"]


def test_filter_bytes_match_readme_golden():
    """The reference's bits for the README config (1000 bits, h 4, k 5)
    are the .bf file's payload, byte for byte."""
    f = ref_bloom.Filter(1000, 4, 5, "cpu")
    f.insert(nthash.encode("TAGAATCACCCAAAGA"))
    with open(os.path.join(GOLDEN, "bf_readme.bf"), "rb") as fh:
        golden = fh.read()
    words = f.words(0, f.bits.numel() // 32)
    assert words.numpy().view(np.uint8)[:125].tobytes() == golden[-125:]


@pytest.mark.parametrize("fasta_bytes,fpr,want", [
    (3_100_000_000, 1e-4, (59_427_361_984, 13)),
    (102_000_000, 1e-4, (1_955_351_936, 13)),
    (1000, 0.01, None)])
def test_writebloom_sizing(fasta_bytes, fpr, want):
    from btl_bloomfilter_tpu_torch.tools import write_bloom
    got = ref_bloom.writebloom_specs(fasta_bytes, fpr)
    assert got == write_bloom.filter_specs(fasta_bytes, fpr)
    if want:
        assert got == want


@pytest.mark.parametrize("x", [0, 1, (1 << 63) - 1, 1 << 63, U64, 0xDEADBEEF,
                               0x9E3779B97F4A7C15])
@pytest.mark.parametrize("m", [1000, 1_955_351_936, 1 << 32,
                               59_427_361_984, (1 << 36) - 64])
def test_umod_is_unsigned(x, m):
    t = torch.tensor([nthash.signed(x)], dtype=torch.int64)
    assert int(nthash.umod(t, m)) == x % m


def _codes(shape, seed, n_share=0.02):
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 4, shape, dtype=torch.uint8, generator=g)
    n = torch.rand(shape, generator=g) < n_share
    return torch.where(n, 4, c).to(torch.uint8)


@pytest.mark.parametrize("size,k,h", [(1 << 20, 31, 13), (999_936, 21, 4),
                                      (1_955_351_936, 31, 13)])
def test_reference_equals_port_plain_path(size, k, h):
    """insert_seq / contains_seq of the port on the CPU and the reference
    set the same bits and answer the same windows."""
    from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
    codes = _codes((12, 300), size % 97)
    bf = kmer_bloom.insert_seq(bloom.create(size, h, k, device="cpu"), codes)
    ref = ref_bloom.Filter(size, h, k, "cpu")
    ref.insert(codes)
    assert ref.words_differing(bf.words) == 0
    probe = torch.cat([codes[:6], _codes((6, 300), 5)])
    hit, valid = kmer_bloom.contains_seq(bf, probe)
    bits, rvalid = ref.probe(probe)
    assert torch.equal(valid, rvalid)
    assert torch.equal(hit, bits.all(dim=0) & rvalid)


def test_wide_positions_equal_port_plain_path():
    """Past 2**32 bits (int64 positions, the human filter's size)."""
    from btl_bloomfilter_tpu_torch.kernels import nthash_scan
    size, k, h = 59_427_361_984, 31, 13
    codes = _codes((8, 200), 3)
    pos, _strand, valid = nthash_scan.positions_planes_plain(codes, k, h,
                                                            size)
    rpos, rvalid = nthash.positions(codes, k, h, size)
    assert torch.equal(valid, rvalid)
    assert torch.equal(pos[:, valid], rpos[:, rvalid])
    assert int(rpos.max()) >= 1 << 32


def test_least_bytes_on_hand_made_batches():
    pos = torch.tensor([[0, 31, 32, 64], [5, 95, 96, 1 << 33]])
    assert ref_bloom.distinct_words(pos) == 5   # words 0-3 and 2**28
    # three windows, h 3: a hit (3 loads), a miss at probe 2 (2 loads), a
    # miss at probe 1 (1 load); the fourth window is invalid (0 loads)
    bits = torch.tensor([[1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1]],
                        dtype=torch.bool)[:, None, :]
    valid = torch.tensor([[True, True, True, False]])
    assert ref_bloom.query_loads(bits, valid) == 3 + 2 + 1


def test_words_differing_counts_each_word():
    f = ref_bloom.Filter(256, 2, 5, "cpu")
    f.bits[[0, 33, 255]] = True
    words = f.words(0, 8).clone()
    assert f.words_differing(words) == 0
    words[1] ^= 4
    words[7] = 0
    assert f.words_differing(words) == 2
