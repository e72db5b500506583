"""Run named cases on P ranks of ``torch.distributed``, one process a rank.

    python -m btl_bloomfilter_tpu_torch.tools.dist_run --world 4 \\
        --cases-file cases.py --cases dp_bloom,sharded_bloom --out DIR

The launcher starts P copies of this module as rank processes (``--rank``
given), each with ``torch.set_num_threads(1)``. They meet through a
``file://`` store under ``--out`` (no TCP port to race for), import
``--cases-file`` by path (it must import torch and this package only, no
JAX) and call each named case as ``case(mesh)``. A case returns a dict of
numpy arrays and numbers, which the rank writes to
``DIR/<case>.rank<r>.npz``; rank 0 also writes ``DIR/summary.json``
(world, backend, device, whether the collectives stage through the host,
seconds a case).

Every wait has a time limit: a collective that one rank never joins fails
on the others after the process group's timeout (``--timeout``, about a
minute), and the launcher kills every rank still running at its own limit
and raises. ``--device cuda:0`` with ``--backend gloo`` puts several ranks
on one card (NCCL takes one rank a device).
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(path: str):
    spec = importlib.util.spec_from_file_location(
        "btl_dist_cases_" + os.path.splitext(os.path.basename(path))[0],
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rank_main(a) -> None:
    from ..parallel import mesh as mesh_lib
    from ..parallel import multihost

    torch.set_num_threads(1)
    multihost.init(f"file://{os.path.join(a.out, 'store')}", a.world,
                   a.rank, device=a.device or "cuda", backend=a.backend,
                   timeout=datetime.timedelta(seconds=a.timeout))
    try:
        mesh = mesh_lib.make_mesh(device=a.device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        cases = _load(a.cases_file)
        seconds = {}
        for name in a.cases.split(","):
            t0 = time.perf_counter()
            out = getattr(cases, name)(mesh)
            seconds[name] = time.perf_counter() - t0
            np.savez(os.path.join(a.out, f"{name}.rank{a.rank}.npz"),
                     **{k: np.asarray(v) for k, v in out.items()})
        multihost.barrier()
        if multihost.is_primary():
            with open(os.path.join(a.out, "summary.json"), "w") as f:
                json.dump({"world": a.world, "backend": mesh.backend,
                           "device": str(mesh.device),
                           "stages_through_host": mesh.stages_through_host,
                           "seconds": seconds}, f)
    finally:
        multihost.shutdown()


def launch(cases_file: str, cases, world: int, out: str, *, device=None,
           backend=None, timeout: float = 60.0,
           limit: float = 300.0) -> dict:
    """Run ``cases`` (names in ``cases_file``) on ``world`` rank
    processes; returns rank 0's summary. The ranks' ``device`` is the
    card (``mesh.make_mesh``'s default, ``cuda:<rank>``) unless the
    caller names one (``"cpu"``, or ``"cuda:0"`` for every rank on one
    card). ``timeout`` is the process group's, ``limit`` the launcher's
    for the whole run: past it every rank is killed and ``TimeoutError``
    raised. A rank that fails raises ``RuntimeError`` with the end of its
    output."""
    os.makedirs(out, exist_ok=True)
    for stale in ("store", "summary.json"):
        if os.path.exists(os.path.join(out, stale)):
            os.remove(os.path.join(out, stale))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    logs, procs = [], []
    try:
        for r in range(world):
            log = open(os.path.join(out, f"rank{r}.log"), "w+")
            logs.append(log)
            cmd = [sys.executable, "-m",
                   "btl_bloomfilter_tpu_torch.tools.dist_run",
                   "--rank", str(r), "--world", str(world), "--out", out,
                   "--cases-file", os.path.abspath(cases_file),
                   "--cases", ",".join(cases), "--timeout", str(timeout)]
            if device is not None:
                cmd += ["--device", str(device)]
            if backend:
                cmd += ["--backend", backend]
            procs.append(subprocess.Popen(cmd, cwd=_ROOT, env=env,
                                          stdout=log, stderr=log))
        deadline = time.monotonic() + limit
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"rank {r} of {world} still running after "
                                   f"{limit} s") from None
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            logs[bad[0]].seek(0)
            tail = logs[bad[0]].read()[-3000:]
            raise RuntimeError(f"ranks {bad} of {world} failed; rank "
                               f"{bad[0]}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for log in logs:
            log.close()
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


def load(out: str, case: str, world: int):
    """The outputs of ``case``: one dict of numpy arrays a rank."""
    res = []
    for r in range(world):
        with np.load(os.path.join(out, f"{case}.rank{r}.npz")) as z:
            res.append({k: z[k] for k in z.files})
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank (the launcher sets it)")
    ap.add_argument("--cases-file", required=True)
    ap.add_argument("--cases", required=True, help="comma-separated names")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the card, "
                         "cuda:<rank>)")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--limit", type=float, default=300.0)
    a = ap.parse_args(argv)
    if a.rank is not None:
        _rank_main(a)
        return
    summary = launch(a.cases_file, a.cases.split(","), a.world, a.out,
                     device=a.device, backend=a.backend, timeout=a.timeout,
                     limit=a.limit)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
