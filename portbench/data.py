"""The traffic generator: genomes and read sets made on the device from a
seed, laid out as ``native.FastaReader`` hands batches to the CLIs.

Everything a configuration or a mix fixes (sequence lengths, N runs, read
length, shares, batch shapes) comes from their JSON files; the seed only
places and picks. So every seed gets the same amount of work.
"""

from __future__ import annotations

import dataclasses

import torch

CODE_N = 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 64))
    return g


@dataclasses.dataclass
class Genome:
    codes: torch.Tensor       # uint8 [total], the sequences end to end
    lengths: list[int]        # of each sequence, in order

    @property
    def starts(self) -> list[int]:
        out, s = [], 0
        for n in self.lengths:
            out.append(s)
            s += n
        return out


def make_genome(config: dict, seed: int, device) -> Genome:
    """Uniform ACGT for every sequence of the configuration, then N runs:
    ``n_runs`` of them with lengths evenly spread over [n_run_min,
    n_run_max], one to each equal slot of the genome, at an offset in its
    slot drawn from the seed."""
    lengths = [int(v) for v in config["sequences"].values()]
    total = sum(lengths)
    g = generator(seed, 0, device)
    codes = torch.randint(0, 4, (total,), dtype=torch.uint8, generator=g,
                          device=device)
    runs = int(config.get("n_runs", 0))
    if runs:
        lo, hi = int(config["n_run_min"]), int(config["n_run_max"])
        lens = torch.linspace(lo, hi, runs, dtype=torch.float64).round()
        lens = lens.to(torch.int64)[torch.randperm(
            runs, generator=generator(seed, 1, "cpu"))]
        slot = total // runs
        if slot < hi:
            raise ValueError("N runs longer than their slots")
        offs = (torch.rand(runs, generator=generator(seed, 2, "cpu"),
                           dtype=torch.float64) * (slot - lens + 1)).floor()
        for i, (o, n) in enumerate(zip(offs.tolist(), lens.tolist())):
            s = i * slot + int(o)
            codes[s:s + n] = CODE_N
    return Genome(codes=codes, lengths=lengths)


def reader_rows(n: int, pad: int, k: int) -> tuple[int, bool]:
    """How FastaReader cuts a sequence of n bases: (full rows of ``pad``
    bases, overlapping by k-1; whether a shorter tail row follows, which it
    does when the rest holds a window)."""
    step = pad - (k - 1)
    full = (n - pad) // step + 1 if n >= pad else 0
    return full, n - full * step >= k


def layout(genome: Genome, batch: int, pad: int, k: int) -> torch.Tensor:
    """The genome as FastaReader batches: uint8 [nbatches, batch, pad]; a
    tail row is padded with N, and so are the rows after the last
    sequence."""
    step = pad - (k - 1)
    cuts = [reader_rows(n, pad, k) for n in genome.lengths]
    nrows = sum(full + tail for full, tail in cuts)
    nb = -(-nrows // batch)
    out = torch.full((nb * batch, pad), CODE_N, dtype=torch.uint8,
                     device=genome.codes.device)
    r = 0
    for s, n, (full, tail) in zip(genome.starts, genome.lengths, cuts):
        seq = genome.codes[s:s + n]
        if full:
            out[r:r + full] = seq.unfold(0, pad, step)[:full]
            r += full
        if tail:
            out[r, :n - full * step] = seq[full * step:]
            r += 1
    return out.view(nb, batch, pad)


def make_reads(genome: Genome, mix: dict, seed: int) -> torch.Tensor:
    """A pool of read batches uint8 [pool_batches, batch, read_length]
    (one row a read, as FastaReader gives reads no longer than its pad):
    in each batch exactly round(batch * host_share) reads are cut from the
    genome at uniform offsets inside one sequence and clear of N, each base
    substituted with probability ``substitution_rate`` and the read reverse
    complemented with probability ``reverse_share``; the rest are uniform
    ACGT; their order is shuffled."""
    dev = genome.codes.device
    nb, batch = int(mix["pool_batches"]), int(mix["batch"])
    L = int(mix["read_length"])
    if int(mix["pad"]) != L:
        raise ValueError("reads are one row each: pad must equal read_length")
    n_host = round(batch * float(mix["host_share"]))
    g = generator(seed, 3, dev)
    ends = torch.tensor(genome.starts[1:] + [genome.codes.numel()],
                        device=dev)
    span = torch.arange(L, device=dev)
    out = torch.empty((nb, batch, L), dtype=torch.uint8, device=dev)
    for b in range(nb):
        starts = torch.randint(0, genome.codes.numel() - L + 1, (n_host,),
                               generator=g, device=dev)
        while True:
            reads = genome.codes[starts[:, None] + span]
            seq_end = ends[torch.searchsorted(ends, starts, right=True)]
            bad = (reads >= CODE_N).any(dim=1) | (starts + L > seq_end)
            nbad = int(bad.sum())
            if not nbad:
                break
            starts[bad] = torch.randint(0, genome.codes.numel() - L + 1,
                                        (nbad,), generator=g, device=dev)
        sub = torch.rand((n_host, L), generator=g, device=dev) < float(
            mix["substitution_rate"])
        shift = torch.randint(1, 4, (n_host, L), dtype=torch.uint8,
                              generator=g, device=dev)
        reads = torch.where(sub, (reads + shift) % 4, reads)
        rev = torch.rand((n_host, 1), generator=g, device=dev) < float(
            mix["reverse_share"])
        reads = torch.where(rev, 3 - reads.flip(1), reads)
        foreign = torch.randint(0, 4, (batch - n_host, L), dtype=torch.uint8,
                                generator=g, device=dev)
        order = torch.randperm(batch, generator=g, device=dev)
        out[b] = torch.cat([reads, foreign])[order]
    return out
