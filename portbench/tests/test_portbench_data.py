"""The traffic generator: FastaReader's layout, the reads' make-up, and
the same inputs for the same seed."""

import pytest
import torch

import tiny
from portbench import data
from portbench.reference import nthash


def _fasta(path, genome):
    with open(path, "w") as f:
        for i, (s, n) in enumerate(zip(genome.starts, genome.lengths)):
            seq = "".join("ACGTN"[c] for c in genome.codes[s:s + n].tolist())
            f.write(f">seq{i} a header\n")
            for j in range(0, n, 60):
                f.write(seq[j:j + 60] + "\n")


@pytest.mark.parametrize("lengths,batch,pad,k", [
    ([300, 5, 64, 65, 1000], 4, 64, 31),
    ([64, 63, 95, 96, 97], 3, 64, 31),
    ([1, 2, 3], 2, 8, 3),
    ([5000, 17, 31], 7, 100, 21),
])
def test_layout_matches_native_fasta_reader(tmp_path, lengths, batch, pad, k):
    from btl_bloomfilter_tpu_torch import native
    g = torch.Generator().manual_seed(sum(lengths))
    genome = data.Genome(codes=torch.randint(0, 5, (sum(lengths),),
                                             dtype=torch.uint8, generator=g),
                         lengths=lengths)
    path = tmp_path / "g.fa"
    _fasta(path, genome)
    with native.FastaReader(str(path), batch, pad, k) as reader:
        want = [torch.from_numpy(b) for b in reader]
    got = data.layout(genome, batch, pad, k)
    assert got.shape[0] == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_genome_is_the_seeds_and_holds_its_n_runs():
    a = data.make_genome(tiny.CONFIG, 7, "cpu")
    b = data.make_genome(tiny.CONFIG, 7, "cpu")
    c = data.make_genome(tiny.CONFIG, 2**31 + 11, "cpu")
    assert torch.equal(a.codes, b.codes)
    assert not torch.equal(a.codes, c.codes)
    lens = torch.linspace(100, 1000, 3).round().to(torch.int64)
    for g in (a, c):
        assert g.codes.numel() == sum(tiny.CONFIG["sequences"].values())
        assert int((g.codes == data.CODE_N).sum()) == int(lens.sum())


def test_reads_are_the_seeds_and_as_the_mix_says():
    genome = data.make_genome(tiny.CONFIG, 5, "cpu")
    mix = dict(tiny.QUERY, batch=400, substitution_rate=0.0)
    a = data.make_reads(genome, mix, 5)
    assert torch.equal(a, data.make_reads(genome, mix, 5))
    assert not torch.equal(a, data.make_reads(genome, mix, 6))
    assert a.shape == (3, 400, 50) and int(a.max()) < 4
    text = "".join("ACGTN"[c] for c in genome.codes.tolist())
    pieces = [text[s:s + n] for s, n in zip(genome.starts, genome.lengths)]
    comp = str.maketrans("ACGT", "TGCA")
    for batch in a:
        found = 0
        for read in batch:
            r = "".join("ACGT"[c] for c in read.tolist())
            found += any(r in p or r[::-1].translate(comp) in p
                         for p in pieces)
        assert found == 360     # exactly round(400 * 0.9): foreign reads
        # of 50 random bases never occur in 50 kb


def test_reads_cut_clear_of_n_and_of_sequence_ends():
    genome = data.Genome(codes=torch.tensor([2] * 30 + [0] * 30 + [4]
                                            + [1] * 60, dtype=torch.uint8),
                         lengths=[30, 91])
    mix = dict(tiny.QUERY, batch=50, host_share=1.0, read_length=30, pad=30,
               substitution_rate=0.0, reverse_share=0.0, pool_batches=1)
    reads = data.make_reads(genome, mix, 1)[0]
    for r in reads.tolist():
        assert r in ([2] * 30, [0] * 30, [1] * 30)


def test_valid_windows_count_windows_without_n():
    codes = torch.tensor([[0, 1, 4, 2, 3, 0, 1], [4, 4, 4, 4, 4, 4, 4]],
                         dtype=torch.uint8)
    assert nthash.valid_windows(codes, 3).sum(dim=1).tolist() == [2, 0]
