"""The classic Bloom filter as writeBloom / testBloom use it.

A session owns the cell's inputs and the port's filter. ``step(j)`` is the
window's j-th batch: exactly the per-batch call of the port's CLIs
(``tools/write_bloom.py``: ``kmer_bloom.insert_seq``; ``tools/test_bloom.py``:
``kmer_bloom.contains_seq``) on a host numpy batch in FastaReader's layout.
``verify`` rebuilds everything with the reference after the window.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import data, trace
from ..reference import bloom as ref_bloom
from ..reference import nthash as ref_nthash


def specs(config: dict) -> tuple[int, int]:
    """(size, h) by writeBloom's sizing; the file states both, and they
    have to agree."""
    size, h = ref_bloom.writebloom_specs(int(config["fasta_bytes"]),
                                         float(config["fpr"]))
    if (size, h) != (config["size_bits"], config["hash_num"]):
        raise ValueError(f"{config['name']}: writeBloom sizes ({size}, {h}), "
                         f"the file states ({config['size_bits']}, "
                         f"{config['hash_num']})")
    return size, h


def port_api():
    from btl_bloomfilter_tpu_torch.models import kmer_bloom
    return kmer_bloom


def _create(size: int, h: int, k: int, device):
    from btl_bloomfilter_tpu_torch.models import bloom
    return bloom.create(size, h, k, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _valid_counts(batches: torch.Tensor, k: int) -> list[int]:
    return [int(ref_nthash.valid_windows(b, k).sum()) for b in batches]


def _genome_batches(config: dict, mix: dict, seed: int, device):
    genome = data.make_genome(config, seed, device)
    return data.layout(genome, int(mix["batch"]), int(mix["pad"]),
                       int(config["kmer_size"])), genome


class Build:
    """Mix kind "build": the genome's batches in order, pass after pass,
    each pass into a zeroed filter."""

    kind = "build"

    def __init__(self, config, mix, seed, device, api, load_mix):
        del load_mix
        self.api, self.device = api, device
        self.size, self.h = specs(config)
        self.k = int(config["kmer_size"])
        lay, genome = _genome_batches(config, mix, seed, device)
        del genome
        self.valid = _valid_counts(lay, self.k)
        self.batches = lay.cpu().numpy()     # pageable, as the CLI holds it
        del lay
        self.bf = _create(self.size, self.h, self.k, device)
        self.api.insert_seq(self.bf, self.batches[0])
        self.bf.words.zero_()
        _sync(device)

    def step(self, j: int) -> None:
        i = j % len(self.batches)
        if i == 0:
            self.bf.words.zero_()
        with torch.profiler.record_function(trace.CALL):
            self.api.insert_seq(self.bf, self.batches[i])

    def work(self, j: int) -> int:
        return self.valid[j % len(self.batches)]

    def verify(self, steps: int, traced: bool):
        """The reference rebuilds the batches of the last pass (the filter
        holds only those) and compares every word; traced, it also counts
        the least bytes of every call: codes read once, each distinct word
        touched read and written once."""
        nb = len(self.batches)
        last = (steps - 1) % nb if steps else -1
        uses = np.bincount(np.arange(steps) % nb, minlength=nb)
        ref = ref_bloom.Filter(self.size, self.h, self.k, self.device)
        least = 0
        for i in range(nb):
            if i > last and not (traced and uses[i]):
                continue
            codes = torch.from_numpy(self.batches[i]).to(self.device)
            if i <= last:
                pos = ref.insert(codes)
            else:
                pos, valid = ref.positions(codes)
                pos = pos[:, valid]
            if traced:
                least += int(uses[i]) * (
                    codes.numel() + 8 * ref_bloom.distinct_words(pos))
        differing = ref.words_differing(self.bf.words)
        checks = {"filter_words_differing": (differing, 0)}
        return checks, (last + 1 if differing else 0), least


class Query:
    """Mix kind "query": the filter filled once in set-up by one pass of
    the mix named by ``fill`` (device-resident codes), then a pool of read
    batches cycled; each batch's per-read hit counts come back to the
    host."""

    kind = "query"

    def __init__(self, config, mix, seed, device, api, load_mix):
        self.api, self.device, self.seed = api, device, seed
        self.config, self.fill = config, load_mix(mix["fill"])
        self.size, self.h = specs(config)
        self.k = int(config["kmer_size"])
        self.bf = _create(self.size, self.h, self.k, device)
        lay, genome = _genome_batches(config, self.fill, seed, device)
        for b in lay:
            self.api.insert_seq(self.bf, b)
        del lay
        pool = data.make_reads(genome, mix, seed)
        del genome
        self.valid = _valid_counts(pool, self.k)
        self.pool = pool.cpu().numpy()
        del pool
        self.answers: list[torch.Tensor] = []
        self._counts(self.pool[0])
        _sync(device)

    def _counts(self, codes) -> torch.Tensor:
        with torch.profiler.record_function(trace.CALL):
            hit, valid = self.api.contains_seq(self.bf, codes)
        return (hit & valid).sum(dim=1, dtype=torch.int16).cpu()

    def step(self, j: int) -> None:
        self.answers.append(self._counts(self.pool[j % len(self.pool)]))

    def work(self, j: int) -> int:
        return self.valid[j % len(self.pool)]

    def verify(self, steps: int, traced: bool):
        """The reference rebuilds the filter from the genome made again
        from the seed, compares every word, then recounts each pool batch
        and compares every answer of the window; traced, it also counts
        the least bytes of every call: codes read once, each window's
        probes up to its first clear bit, one bool a window written."""
        lay, genome = _genome_batches(self.config, self.fill, self.seed,
                                      self.device)
        del genome
        ref = ref_bloom.Filter(self.size, self.h, self.k, self.device)
        for b in lay:
            ref.insert(b)
        del lay
        differing = ref.words_differing(self.bf.words)
        want, least_of = [], []
        for codes in self.pool:
            codes = torch.from_numpy(codes).to(self.device)
            bits, valid = ref.probe(codes)
            want.append((bits.all(dim=0) & valid).sum(dim=1).cpu())
            least_of.append(codes.numel() + valid.numel() + 4 * (
                ref_bloom.query_loads(bits, valid) if traced else 0))
        wrong_reads = wrong_batches = 0
        for j, got in enumerate(self.answers[:steps]):
            d = int((got.to(torch.int64) != want[j % len(want)]).sum())
            wrong_reads += d
            wrong_batches += d > 0
        least = sum(least_of[j % len(least_of)] for j in range(steps))
        checks = {"filter_words_differing": (differing, 0),
                  "read_counts_differing": (wrong_reads, 0)}
        return checks, wrong_batches, least if traced else 0


SESSIONS = {"build": Build, "query": Query}


def open_session(config, mix, seed, device, load_mix, api=None):
    return SESSIONS[mix["kind"]](config, mix, seed, device,
                                 api or port_api(), load_mix)
