"""The staging ring (``utils/staging.py``) behind ``kmer_bloom``'s entries.

On the CPU: the chunk plan, which codes take the ring, and, through a ring
that stands in for the card's, that chunked staging gives the entries the
same filter and answers as one copy. Marked ``cuda`` (skipped without a
card): the ring itself against one-shot staging, a caller that overwrites
its array as soon as a call returns, back-to-back inserts through every
slot and past a slot's size, and the ring's counters. This file imports neither jax nor the JAX
package; on the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_staging.py
"""

import numpy as np
import pytest
import torch

from btl_bloomfilter_tpu_torch.models import bloom, kmer_bloom
from btl_bloomfilter_tpu_torch.utils import staging, trace

K, H = 15, 3
CHUNK = staging.CHUNK_BYTES


def random_codes(B, L, seed=0, n_share=0.02):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < n_share] = 4
    if B * L > 40:                      # an N run across a row's edge
        codes.reshape(-1)[B * L // 2 - 20:B * L // 2 + 20] = 4
    return codes


def check_plan(rows, row_bytes, chunk=CHUNK):
    bounds = staging.plan(rows, row_bytes, chunk)
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(a < b for a, b in bounds)
    assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
    lengths = [b - a for a, b in bounds]
    assert max(lengths) - min(lengths) <= 1
    per = max(1, chunk // row_bytes)
    assert max(lengths) <= per           # fits a slot, or one row
    assert len(bounds) == -(-rows // per)    # as few as fit
    return bounds


@pytest.mark.parametrize("row_bytes", [1, 150, 1024, CHUNK // 3, CHUNK + 1])
def test_plan_covers_every_row_once_in_order(row_bytes):
    per = max(1, CHUNK // row_bytes)
    for rows in (1, 2, per, per + 1, 3 * per - 1, 65537):
        check_plan(rows, row_bytes)
    assert staging.plan(0, row_bytes, CHUNK) == []


def test_plan_of_the_bench_batches():
    # a query batch of 65,536 reads of 150 in three chunks, a build batch
    # of 4096 x 1024 (4 MiB) in one
    assert check_plan(65536, 150) == [(0, 21846), (21846, 43691),
                                      (43691, 65536)]
    assert check_plan(4096, 1024) == [(0, 4096)]
    assert len(check_plan(4097, 1024)) == 2


@pytest.mark.parametrize("rows,row_bytes", [(1, 150), (1, CHUNK),
                                            (CHUNK // 150, 150),
                                            (512, 1024), (4096, 1024)])
def test_input_under_one_chunk_takes_a_single_copy(rows, row_bytes):
    assert rows * row_bytes <= CHUNK
    assert staging.plan(rows, row_bytes, CHUNK) == [(0, rows)]


def test_which_codes_take_the_ring(monkeypatch):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    codes = torch.from_numpy(random_codes(4, 100))
    assert staging.takes(codes, cuda)
    assert staging.takes(torch.as_tensor(codes.tolist()), cuda)
    assert not staging.takes(codes, cpu)
    assert not staging.takes(codes[:0], cuda)
    assert not staging.takes(torch.zeros(1, CHUNK + 1, dtype=torch.uint8),
                             cuda)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    assert not staging.takes(codes, cuda)


def test_cpu_filter_never_takes_the_ring(monkeypatch):
    def refuse(device):
        raise AssertionError("a CPU filter reached the staging ring")

    monkeypatch.setattr(staging, "ring", refuse)
    bf = bloom.create(1 << 20, H, K, device="cpu")
    codes = random_codes(9, 120)
    trace.reset_counters()
    kmer_bloom.insert_seq(bf, codes)
    kmer_bloom.contains_seq(bf, codes)
    kmer_bloom.contains_kmers(bf, codes[:, :K])
    c = trace.counters()
    assert c["stage.chunks"] == c["stage_bytes.ring"] == 0
    assert c["stage_bytes.none"] == 2 * codes.nbytes + 9 * K


class CpuRing:
    """The ring's contract on the CPU: chunks in plan order, each a copy,
    overwritten once ``fn`` has returned."""

    def __init__(self, chunk_bytes):
        self.chunk_bytes = chunk_bytes
        self.slot = None
        self.chunks = []

    def map(self, fn, flat, split):
        pieces = staging.plan(flat.shape[0],
                              flat.shape[1] * flat.element_size(),
                              self.chunk_bytes)
        for group in ([p] for p in pieces) if split else [pieces]:
            a, b = group[0][0], group[-1][1]
            self.chunks.append((a, b))
            self.slot = flat[a:b].clone()
            out = fn(self.slot)
            self.slot.fill_(3)           # the next chunk's copy lands here
            yield out


@pytest.mark.parametrize("shape", [(1, 150), (7, 150), (10, 33, 64)])
def test_chunked_entries_equal_one_copy_on_cpu(monkeypatch, shape):
    codes = random_codes(int(np.prod(shape[:-1])), shape[-1],
                         seed=sum(shape)).reshape(shape)
    want = bloom.create(1 << 20, H, K, device="cpu")
    kmer_bloom.insert_seq(want, codes)
    want_hit, want_valid = kmer_bloom.contains_seq(want, codes)
    want_kmers = kmer_bloom.contains_kmers(want, codes[..., :K])

    row_bytes = shape[-1]
    ring = CpuRing(3 * row_bytes)
    monkeypatch.setattr(staging, "takes", lambda flat, device: True)
    monkeypatch.setattr(staging, "ring", lambda device: ring)
    bf = bloom.create(1 << 20, H, K, device="cpu")
    kmer_bloom.insert_seq(bf, codes)
    hit, valid = kmer_bloom.contains_seq(bf, codes)
    assert torch.equal(bf.words, want.words)
    assert torch.equal(hit, want_hit) and torch.equal(valid, want_valid)
    assert hit.shape == shape[:-1] + (shape[-1] - K + 1,)
    assert torch.equal(kmer_bloom.contains_kmers(bf, codes[..., :K]),
                       want_kmers)
    rows = int(np.prod(shape[:-1]))
    plan = staging.plan(rows, row_bytes, 3 * row_bytes)
    assert ring.chunks[0] == (0, rows) and ring.chunks[1:1 + len(plan)] == plan


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


# a narrow filter (int32 positions, tiled insert from 2**21 positions) and
# a wide one (int64 positions past 2**32 bits)
SIZES = [1 << 30, (1 << 33) + 64]


def one_shot(dev, size, batches, k=31, h=4):
    """The filter and answers with every batch handed over on the card:
    no staging at all."""
    bf = bloom.create(size, h, k, device=dev)
    for b in batches:
        kmer_bloom.insert_seq(bf, torch.from_numpy(b).to(dev))
    answers = [kmer_bloom.contains_seq(bf, torch.from_numpy(b).to(dev))
               for b in batches]
    return bf, answers


def outside_ring(dev, *tensors):
    r = staging.ring(dev)
    spans = [(t.data_ptr(), t.data_ptr() + t.numel())
             for t in r.dev + r.host]
    for t in tensors:
        a, b = t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()
        assert all(b <= lo or a >= hi for lo, hi in spans)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("B,L", [(1, 150), (65537, 150), (8192, 1024)])
def test_cuda_ring_equals_one_shot(dev, size, B, L):
    codes = random_codes(B, L, seed=B)
    want, ((want_hit, want_valid),) = one_shot(dev, size, [codes])
    bf = bloom.create(size, 4, 31, device=dev)
    trace.reset_counters()
    kmer_bloom.insert_seq(bf, codes)
    hit, valid = kmer_bloom.contains_seq(bf, codes)
    torch.cuda.synchronize()
    assert torch.equal(bf.words, want.words)
    assert torch.equal(hit, want_hit) and torch.equal(valid, want_valid)
    outside_ring(dev, hit, valid)
    c = trace.counters()
    assert c["stage_bytes.pageable"] == 0
    assert c["stage_bytes.ring"] == 2 * codes.nbytes
    assert c["stage.chunks"] == 2 * len(staging.plan(B, L, CHUNK))


@pytest.mark.cuda
def test_cuda_caller_overwrites_its_array_on_return(dev):
    batches = [random_codes(65536, 150, seed=s) for s in range(2)]
    want, answers = one_shot(dev, 1 << 30, batches)
    bf = bloom.create(1 << 30, 4, 31, device=dev)
    buf = np.empty_like(batches[0])
    for b in batches:                     # FastaReader reuses its buffer
        buf[:] = b
        kmer_bloom.insert_seq(bf, buf)
        buf[:] = 4
    got = []
    for b in batches:
        buf[:] = b
        got.append(kmer_bloom.contains_seq(bf, buf))
        buf[:] = 0
    torch.cuda.synchronize()
    assert torch.equal(bf.words, want.words)
    for (hit, valid), (want_hit, want_valid) in zip(got, answers):
        assert torch.equal(hit, want_hit) and torch.equal(valid, want_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_cuda_back_to_back_inserts_through_every_slot(dev, size):
    batches = [random_codes(4096, 1024, seed=10 + i)
               for i in range(3 * staging.SLOTS)]
    want = bloom.create(size, 4, 31, device=dev)
    for b in batches:
        kmer_bloom.insert_seq(want, torch.from_numpy(b).to(dev))
    bf = bloom.create(size, 4, 31, device=dev)
    trace.reset_counters()
    for b in batches:
        kmer_bloom.insert_seq(bf, b)
    torch.cuda.synchronize()
    assert torch.equal(bf.words, want.words)
    c = trace.counters()
    assert c["stage.chunks"] == len(batches)
    assert c["stage_bytes.ring"] == sum(b.nbytes for b in batches)
    assert 0 <= c["stage.slot_waits"] <= len(batches)


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_cuda_back_to_back_inserts_past_a_slot(dev, size):
    """Whole batches of 8-16 MiB, each of another size, inserted back to
    back between queries and k-mer lookups of more than a slot: each lands
    in a buffer of its own, dropped while the kernels that read it may
    still be queued. The filter and answers equal one-shot staging's, and
    the ring's slots keep their size."""
    rows = [8192, 12289, 16384, 9731, 14000, 10240]
    batches = [random_codes(r, 1024, seed=60 + i) for i, r in enumerate(rows)]
    kmers = random_codes(300_000, 31, seed=59)
    queries = random_codes(65536, 150, seed=58)

    def run(stage):
        bf = bloom.create(size, 4, 31, device=dev)
        answers = []
        for b in batches:
            kmer_bloom.insert_seq(bf, stage(b))
            answers.append(kmer_bloom.contains_seq(bf, stage(queries)))
            answers.append((kmer_bloom.contains_kmers(bf, stage(kmers)),))
        torch.cuda.synchronize()
        return bf, answers

    want, want_answers = run(lambda b: torch.from_numpy(b).to(dev))
    trace.reset_counters()
    bf, answers = run(lambda b: b)
    assert torch.equal(bf.words, want.words)
    for got, w in zip(answers, want_answers):
        assert all(torch.equal(x, y) for x, y in zip(got, w))
    assert all(t.numel() == CHUNK for t in staging.ring(dev).dev)
    c = trace.counters()
    assert c["stage_bytes.ring"] == sum(
        b.nbytes + queries.nbytes + kmers.nbytes for b in batches)


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True])
def test_cuda_and_pinned_codes_never_take_the_ring(dev, pinned):
    codes = torch.from_numpy(random_codes(64, 200))
    codes = codes.pin_memory() if pinned else codes.to(dev)
    assert not staging.takes(codes, dev)
    bf = bloom.create(1 << 26, 4, 31, device=dev)
    trace.reset_counters()
    kmer_bloom.insert_seq(bf, codes)
    kmer_bloom.contains_seq(bf, codes)
    c = trace.counters()
    assert c["stage.chunks"] == c["stage_bytes.ring"] == 0
    assert c["stage_bytes.pinned" if pinned else "stage_bytes.none"] == (
        2 * codes.numel())


@pytest.mark.cuda
def test_cuda_threads_share_the_ring(dev):
    """More threads than cores stage through the device's one ring, each
    into its own filter; every filter and answer equals its one-shot
    twin."""
    import sys
    import threading

    batches = [random_codes(512 + 1597 * i, 300, seed=40 + i)
               for i in range(16)]          # the last ones in two chunks
    want = [one_shot(dev, 1 << 26, [b]) for b in batches]
    got = [None] * len(batches)

    def work(i):
        bf = bloom.create(1 << 26, 4, 31, device=dev)
        for _ in range(3):
            kmer_bloom.insert_seq(bf, batches[i])
            hit, valid = kmer_bloom.contains_seq(bf, batches[i])
        torch.cuda.synchronize()
        got[i] = bf, hit, valid

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for (bf, hit, valid), (w, ((w_hit, w_valid),)) in zip(got, want):
        assert torch.equal(bf.words, w.words)
        assert torch.equal(hit, w_hit) and torch.equal(valid, w_valid)
