"""btl_bloomfilter's counting Bloom filter as a solid k-mer counter: every
k-mer of a read set counted by conservative update (incrementMin) into
one-byte counters, so that the solid k-mers (min count >= kc) can be kept.

A session owns the cell's read pool and the port's counting filter.
``step(j)`` is the window's j-th batch: ``counting.insert_seq`` on a host
numpy batch of reads in FastaReader's layout. ``verify`` completes the
pass the window was in and rebuilds that whole pass with the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import data, trace
from ..reference import counting as ref_counting
from .bloom import _sync, _valid_counts

COUNTER_WIDTH = 1


def port_api():
    from btl_bloomfilter_tpu_torch.models import counting
    return counting


class Build:
    """Mix kind "build": the read pool's batches in order, pass after
    pass, each pass into counters zeroed inside the window."""

    kind = "build"

    def __init__(self, config, mix, seed, device, api, load_mix):
        del load_mix
        if int(config["counter_width"]) != COUNTER_WIDTH:
            raise ValueError("the reference counts one-byte counters")
        self.api, self.device = api, device
        self.h, self.k = int(config["hash_num"]), int(config["kmer_size"])
        self.size = int(config["size_in_bytes"]) // COUNTER_WIDTH
        genome = data.make_genome(config, seed, device)
        pool = data.make_reads(genome, mix, seed)
        del genome
        self.valid = _valid_counts(pool, self.k)
        self.batches = pool.cpu().numpy()    # pageable, as a reader holds it
        del pool
        self.cbf = api.create(int(config["size_in_bytes"]), self.h, self.k,
                              int(config["count_threshold"]), COUNTER_WIDTH,
                              device=device)
        self.api.insert_seq(self.cbf, self.batches[0])
        self.cbf.counters.zero_()
        _sync(device)

    def step(self, j: int) -> None:
        i = j % len(self.batches)
        if i == 0:
            self.cbf.counters.zero_()
        with torch.profiler.record_function(trace.CALL):
            self.api.insert_seq(self.cbf, self.batches[i])

    def work(self, j: int) -> int:
        return self.valid[j % len(self.batches)]

    def verify(self, steps: int, traced: bool):
        """Finish the pass in progress through the same ``insert_seq``
        (outside the window), so that the counters hold one whole pass of
        the pool, piled up as far as the cell goes; the reference counts
        that pass in order and compares every counter word. Traced, it
        also counts the least bytes of every call of the window: codes read
        once, each distinct counter word touched read and written once."""
        nb = len(self.batches)
        start = steps % nb
        if start or not steps:
            for i in range(start, nb):
                self.api.insert_seq(self.cbf, self.batches[i])
            _sync(self.device)
        uses = np.bincount(np.arange(steps) % nb, minlength=nb)
        ref = ref_counting.Counters(self.size, self.h, self.k, self.device)
        least = 0
        for i in range(nb):
            codes = torch.from_numpy(self.batches[i]).to(self.device)
            frames = ref.insert(codes)
            if traced and uses[i]:
                least += int(uses[i]) * (
                    codes.numel() + 8 * ref_counting.distinct_words(frames))
        differing = ref.words_differing(self.cbf.counters)
        checks = {"counter_words_differing": (differing, 0)}
        return checks, (min(steps, nb) if differing else 0), least


SESSIONS = {"build": Build}


def open_session(config, mix, seed, device, load_mix, api=None):
    if mix["kind"] not in SESSIONS:
        raise ValueError(f"the counting filter runs no {mix['kind']!r} mix")
    return SESSIONS[mix["kind"]](config, mix, seed, device,
                                 api or port_api(), load_mix)
