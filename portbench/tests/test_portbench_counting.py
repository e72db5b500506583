"""The counting cells' filter module at a tiny size on the CPU: a sound run is
correct, every fault and the no-replay control are not, the reference
equals a one-frame-at-a-time loop, and nothing loads JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import data, run
from portbench.control_counting import NoReplayApi
from portbench.reference import counting as ref_counting

CELL = "wbcel235.count.reads30x"
# a counting filter small enough that a batch's frames chain several rounds
# deep, and a read set of about 4.5x
CONFIG = {"name": "tiny-count", "filter": "counting",
          "size_in_bytes": 4096, "counter_width": 1, "hash_num": 4,
          "kmer_size": 31, "count_threshold": 3,
          "sequences": {"a": 3000, "b": 1000, "c": 200}, "n_runs": 0}
MIX = {"kind": "build", "batch": 64, "read_length": 60, "pad": 60,
       "host_share": 1.0, "substitution_rate": 0.01, "reverse_share": 0.5,
       "pool_batches": 5}


def _run(api=None, traced=False, seed=2**31 + 11):
    bench = run.load_benchmark()
    e2e, layer = run.cell_metrics(bench, CELL)
    return run.run(CONFIG, MIX, e2e, layer, seed=seed, seconds=0.3,
                   traced=traced, device="cpu", mixes={}.get, api=api)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    res = _run(traced=traced)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"counter_words_differing": {"value": 0,
                                                         "limit": 0}}
    if not traced:
        assert set(res["metrics"]) == {"build_kmers_per_s", "setup_s"}
    else:
        assert res["metrics"] == {}     # no device trace on the CPU


class Faulty:
    """The port's counting entry points with one fault planted."""

    def __init__(self, fault):
        from btl_bloomfilter_tpu_torch.models import counting
        self.cm, self.fault = counting, fault
        self.create = counting.create

    def insert_seq(self, cbf, codes):
        codes = torch.as_tensor(codes)
        if self.fault == "unchanged":
            return cbf
        if self.fault == "half":
            return self.cm.insert_seq(cbf, codes[:codes.shape[0] // 2])
        self.cm.insert_seq(cbf, codes)
        if self.fault == "altered":     # the first word written, cleared
            cbf.counters[torch.nonzero(cbf.counters)[0]] = 0
        return cbf


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_faults_are_not_correct(fault):
    res = _run(api=Faulty(fault))
    assert res["correct"] is False
    assert res["checks"]["counter_words_differing"]["value"] > 0


def test_no_replay_control_is_not_correct():
    res = _run(api=NoReplayApi())
    assert res["correct"] is False
    assert res["checks"]["counter_words_differing"]["value"] > 10


@pytest.mark.parametrize("steps", [0, 2, 5, 7])
@pytest.mark.parametrize("rest", ["port", "skipped"])
def test_verify_compares_the_whole_pass(steps, rest):
    """A window that ends inside a pass (or before one): ``verify`` runs
    the rest of that pass through the same insert, and compares counters
    piled up over every batch of it; a fault in batches the window never
    reached is caught."""
    from portbench.filters import counting as counting_filter
    session = counting_filter.open_session(CONFIG, MIX, 7, torch.device("cpu"),
                                  {}.get)
    for j in range(steps):
        session.step(j)
    if rest == "skipped":
        session.api = Faulty("unchanged")
    checks, failed, _least = session.verify(steps, traced=False)
    (differing, limit), = checks.values()
    whole = steps % MIX["pool_batches"] == 0 and steps > 0
    assert (differing == limit == 0) == (rest == "port" or whole)
    assert failed == (0 if differing == 0 else min(steps, 5))


def one_at_a_time(frames, size):
    """incrementMin frame after frame, as the C++ loop runs it."""
    c = np.zeros(size, dtype=np.int64)
    for f in frames.tolist():
        low = min(c[p] for p in f)
        if low < 255:
            for p in set(f):
                if c[p] == low:
                    c[p] += 1
    return c


def test_reference_equals_one_frame_at_a_time():
    cfg = CONFIG
    genome = data.make_genome(cfg, 5, "cpu")
    pool = data.make_reads(genome, MIX, 5)
    ref = ref_counting.Counters(cfg["size_in_bytes"], cfg["hash_num"],
                                cfg["kmer_size"], "cpu")
    frames, rounds = [], []
    for b in pool[:2]:
        f = ref.frames(b)
        rounds.append(ref.apply(f))
        frames.append(f)
    want = one_at_a_time(torch.cat(frames), cfg["size_in_bytes"])
    assert np.array_equal(ref.counts.numpy().astype(np.int64), want)
    assert min(rounds) >= 3


def test_no_jax_after_a_counting_rehearsal():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from test_portbench_counting import CONFIG, MIX\n"
        "from portbench import run\n"
        "b = run.load_benchmark()\n"
        "e, l = run.cell_metrics(b, %r)\n"
        "r = run.run(CONFIG, MIX, e, l, seed=1,"
        " seconds=0.1, traced=False, device='cpu', mixes={}.get)\n"
        "assert r['correct']\n"
        "print(run.forbidden_modules())\n"
        % (ROOT, os.path.dirname(__file__), CELL))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH="")).stdout
    assert out.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_cuda_counting_run_is_correct_at_a_small_size(cuda_device):
    """The port's counting path against the reference on the card, traced,
    and the no-replay control."""
    bench = run.load_benchmark()
    e2e, layer = run.cell_metrics(bench, CELL)
    for api, want in ((None, True), (NoReplayApi(), False)):
        res = run.run(CONFIG, MIX, e2e, layer, seed=3, seconds=0.5,
                      traced=api is None, device=cuda_device,
                      mixes={}.get, api=api)
        assert res["correct"] is want, res["checks"]
        if api is None:
            m = res["metrics"]
            assert m["stage_pageable_pct.build"]["value"] == 0
            assert m["count_steps_per_call"]["value"] >= 2
            assert {"count_replay_pct", "count_step_ms", "insert_roofline",
                    "device_idle_pct.build", "h2d_ms.build"} <= set(m)
