"""The port's k-mer layer (plain PyTorch path) against the JAX package:
kmer_bloom, the .bf codec against the C++-derived golden files, FASTA
batching, the pipelines and the write_bloom / test_bloom CLIs.

Inputs are made with numpy from fixed seeds and handed to both sides; all
compared outputs are integers, bools or bytes, so the tolerance is zero.
"""

import os

import jax
import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu import api as jax_api
from btl_bloomfilter_tpu import native as jax_native
from btl_bloomfilter_tpu.io import bf_format as jax_bf_format
from btl_bloomfilter_tpu.io import fasta as jax_fasta
from btl_bloomfilter_tpu.models import bloom as jax_bloom
from btl_bloomfilter_tpu.models import kmer_bloom as jax_kmer_bloom
from btl_bloomfilter_tpu_torch import api, native
from btl_bloomfilter_tpu_torch.io import bf_format, fasta
from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
from btl_bloomfilter_tpu_torch.ops import nthash_tables, u64
from btl_bloomfilter_tpu_torch.tools import test_bloom, write_bloom

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
README_SEQ = "TAGAATCACCCAAAGA"
UNIT_SEQ = "ACGTAC"

# jitted JAX references: eager JAX dispatches op by op and is slow on the CPU
jax_insert_seq = jax.jit(jax_kmer_bloom.insert_seq)
jax_contains_seq = jax.jit(jax_kmer_bloom.contains_seq)
jax_insert_kmers = jax.jit(jax_kmer_bloom.insert_kmers)
jax_contains_kmers = jax.jit(jax_kmer_bloom.contains_kmers)


def golden_bytes(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        return f.read()


def random_codes(shape, nfrac, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    return np.where(rng.random(shape) < nfrac, np.uint8(4), codes)


@pytest.mark.parametrize("shape,size,h,k", [
    ((8, 200), 1 << 14, 4, 31),
    ((2, 4, 90), 1000, 3, 11),     # extra leading axis, size not 2**n
    ((150,), 4096, 2, 7),          # a single 1-D sequence
])
def test_insert_contains_seq_match_jax(shape, size, h, k):
    a = random_codes(shape, 0.05, 1)
    b = random_codes(shape, 0.05, 2)
    jbf = jax_insert_seq(jax_bloom.create(size, h, k), a)
    bf = kmer_bloom.insert_seq(bloom.create(size, h, k, device="cpu"), a)
    np.testing.assert_array_equal(bloom.to_numpy_words(bf),
                                  np.asarray(jbf.words))
    for codes in (a, b):
        ref_hit, ref_valid = jax_contains_seq(jbf, codes)
        hit, valid = kmer_bloom.contains_seq(bf, codes)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def test_insert_contains_kmers_match_jax():
    k, h, size = 9, 3, 1 << 12
    kmers = random_codes((30, k), 0.05, 3)     # some hold an N
    probe = np.concatenate([kmers[:10], random_codes((20, k), 0.0, 4)])
    jbf = jax_insert_kmers(jax_bloom.create(size, h, k), kmers)
    bf = kmer_bloom.insert_kmers(bloom.create(size, h, k, device="cpu"), kmers)
    np.testing.assert_array_equal(bloom.to_numpy_words(bf),
                                  np.asarray(jbf.words))
    np.testing.assert_array_equal(
        kmer_bloom.contains_kmers(bf, probe).numpy(),
        np.asarray(jax_contains_kmers(jbf, probe)))


def test_string_helpers():
    bf = kmer_bloom.insert_string(bloom.create(1000, 4, 5, device="cpu"),
                                  README_SEQ)
    assert kmer_bloom.contains_string(bf, README_SEQ[3:8]).item()
    jbf = jax_insert_seq(jax_bloom.create(1000, 4, 5),
                         nthash_tables.encode_seq(README_SEQ))
    for kmer in ("GGGGG", "TAGAA", "ACGTN"):
        assert kmer_bloom.contains_string(bf, kmer).item() == bool(
            jax_contains_kmers(jbf, nthash_tables.encode_seq(kmer)))


@pytest.mark.parametrize("seq,size,h,k,kw,golden", [
    (README_SEQ, 1000, 4, 5, {}, "bf_readme.bf"),
    (UNIT_SEQ, 512, 3, 4, {"n_entry": 7, "t_entry": 11}, "bf_entries.bf"),
])
def test_store_bloom_matches_golden(tmp_path, seq, size, h, k, kw, golden):
    bf = kmer_bloom.insert_string(
        bloom.create(size, h, k, **kw, device="cpu"), seq)
    path = tmp_path / "out.bf"
    bf_format.store_bloom(bf, str(path))
    assert path.read_bytes() == golden_bytes(golden)


@pytest.mark.parametrize("golden", ["bf_readme.bf", "bf_entries.bf"])
def test_load_bloom_golden(tmp_path, golden):
    path = tmp_path / "g.bf"
    path.write_bytes(golden_bytes(golden))
    bf = bf_format.load_bloom(str(path), device="cpu")
    ref = jax_bf_format.load_bloom(str(path))
    assert (bf.size, bf.hash_num, bf.kmer_size, bf.dfpr, bf.n_entry,
            bf.t_entry) == (ref.size, ref.hash_num, ref.kmer_size, ref.dfpr,
                            ref.n_entry, ref.t_entry)
    np.testing.assert_array_equal(bloom.to_numpy_words(bf),
                                  np.asarray(ref.words))
    if golden == "bf_readme.bf":
        hit, valid = kmer_bloom.contains_seq(
            bf, nthash_tables.encode_seq(README_SEQ))
        assert valid.all() and hit.all()


def test_bf_round_trip_keeps_metadata(tmp_path):
    bf = kmer_bloom.insert_seq(
        bloom.create(4096, 5, 21, dfpr=0.25, n_entry=3, t_entry=9,
                     device="cpu"),
        random_codes((4, 100), 0.0, 5))
    path = tmp_path / "rt.bf"
    bf_format.store_bloom(bf, str(path))
    back = bf_format.load_bloom(str(path), device="cpu")
    assert torch.equal(back.words, bf.words)
    assert (back.dfpr, back.n_entry, back.t_entry) == (0.25, 3, 9)


def test_bucketing_and_padding():
    for n in (5, 64, 65, 1000):
        assert api.bucket_length(n) == jax_api.bucket_length(n)
    codes = nthash_tables.encode_seq("ACGTN")
    np.testing.assert_array_equal(api.pad_codes(codes, 64),
                                  jax_api.pad_codes(codes, 64))


def test_bloom_pipeline_matches_jax_on_two_buckets():
    size, h, k = 1 << 14, 3, 15
    pipe = api.BloomPipeline(bloom.create(size, h, k, device="cpu"))
    jpipe = jax_api.BloomPipeline(jax_bloom.create(size, h, k))
    batches = [random_codes((8, 128), 0.03, 6),
               random_codes((8, 256), 0.03, 7)]
    for codes in batches:
        pipe.insert_batch(codes)
        jpipe.insert_batch(codes)
    np.testing.assert_array_equal(bloom.to_numpy_words(pipe.bf),
                                  np.asarray(jpipe.bf.words))
    for codes in batches + [random_codes((8, 256), 0.03, 8)]:
        hit, valid = pipe.query_batch(codes)
        ref_hit, ref_valid = jpipe.query_batch(codes)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


def test_hash_pipeline_matches_jax():
    seqs = [random_codes((n,), 0.05, n) for n in (40, 150, 70)]
    hp = api.HashPipeline(11, 3, device="cpu")
    jhp = jax_api.HashPipeline(11, 3)
    assert hp.frames(seqs[0][:5]) is None
    for got, ref in [(hp.frames(seqs[1]), jhp.frames(seqs[1])),
                     (hp.frames_batch(seqs), jhp.frames_batch(seqs))]:
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_array_equal(u64.to_numpy(got.hashes),
                                      ref.hashes.astype_numpy())


def write_fasta(path, seed):
    """Multi-FASTA with lowercase, N runs, wrapped lines and reads longer
    than the batch pad."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    with open(path, "w") as f:
        for i, n in enumerate((40, 300, 700, 20, 260)):
            seq = alphabet[rng.integers(0, 9, size=n)].tobytes().decode()
            f.write(f">r{i} some description\n")
            for j in range(0, n, 60):
                f.write(seq[j: j + 60] + "\n")


def test_fasta_batching_matches_jax(tmp_path):
    path = str(tmp_path / "reads.fa")
    write_fasta(path, 9)
    got = list(fasta.batch_fasta(path, 4, 128, 15))
    ref = list(jax_fasta.batch_fasta(path, 4, 128, 15))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        assert a.headers == b.headers
    with native.FastaReader(path, 4, 128, 15) as reader:
        got_native = list(reader)
    ref_native = list(jax_native.FastaReader(path, 4, 128, 15))
    assert len(got_native) == len(ref_native)
    for a, b in zip(got_native, ref_native):
        np.testing.assert_array_equal(a, b)


def test_write_bloom_cli_matches_jax(tmp_path, capsys):
    fa = str(tmp_path / "reads.fa")
    out = str(tmp_path / "port.bf")
    write_fasta(fa, 10)
    write_bloom.main(["-f", fa, "-k", "15", "-o", out, "--batch", "4",
                      "--pad", "128", "--device", "cpu"])

    size, hash_num = write_bloom.filter_specs(os.path.getsize(fa), 0.0001)
    jbf = jax_bloom.create(size, hash_num, 15)
    for codes in jax_native.FastaReader(fa, 4, 128, 15):
        jbf = jax_insert_seq(jbf, codes)
    ref = str(tmp_path / "jax.bf")
    jax_bf_format.store_bloom(jbf, ref)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()

    capsys.readouterr()
    test_bloom.main(["-f", fa, "-b", out, "--batch", "4", "--pad", "128",
                     "--device", "cpu"])
    err = capsys.readouterr().err
    found, total = [int(w) for w in err.split() if w.isdigit()]
    assert found == total > 0
