"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload grch38.build --seed 7 --seconds 10 --trace 0

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json`` at the root of the checkout. Set-up makes the
inputs from the seed and warms every shape; the window then drives the
port for ``--seconds``; afterwards the reference checks what the window
produced. The last line of standard output is the result as one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error and the last key of the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import trace  # noqa: E402

# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "btl_bloomfilter_tpu")


def fix_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, whatever the
    program or the environment would pick (before CUDA starts)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "mixes", f"{name}.json")) as f:
        return json.load(f)


def load_config(bench: dict, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def read_metric(name: str, ctx) -> float | None:
    """``metrics/<name>.py``'s ``read(ctx)``: a number, or None when the
    run holds nothing for it to read."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + "".join(c if c.isalnum() else "_"
                                      for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def peaks(kind: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f).get(kind, {})


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run(config: dict, mix: dict, e2e: list, layer: list, *, seed: int,
        seconds: float, traced: bool, device, chips: int = 1,
        t_start: float = T_START, api=None, mixes=load_mix) -> dict:
    """Set up, drive the window, check it; returns the result object."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = importlib.import_module(f"portbench.filters.{config['filter']}")
    t_session = time.perf_counter()
    session = driver.open_session(config, mix, seed, device, mixes, api)
    t_opened = time.perf_counter()
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    if cuda:
        torch.cuda.synchronize(device)
    latencies, steps = [], 0
    with torch.profiler.record_function(trace.WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            a = time.perf_counter()
            session.step(steps)
            latencies.append(time.perf_counter() - a)
            steps += 1
        if cuda:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.summarize(trace.export(prof))
        del prof
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    t2 = time.perf_counter()
    checks, failed, least = session.verify(steps, traced)
    print(f"portbench: set-up {t0 - t_start:.3f} s (imports "
          f"{t_session - t_start:.3f}, inputs, fill and warm-up "
          f"{t_opened - t_session:.3f}), window {t1 - t0:.3f} s ({steps} "
          f"batches), trace read {t2 - t1:.3f} s, reference "
          f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)
    ctx = types.SimpleNamespace(
        kind=session.kind, setup_s=t0 - t_start, window_s=t1 - t0,
        steps=steps, work=sum(session.work(j) for j in range(steps)),
        latencies_s=np.array(latencies), trace=summary, least_bytes=least,
        peaks=peaks(kind))
    del session
    metrics = {}
    for m in (layer if traced else e2e):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": steps, "failed": failed, "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fix_cache_dirs()
    bench = load_benchmark()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    e2e, layer = cell_metrics(bench, cell["name"])
    result = run(load_config(bench, cell["config"]),
                 load_mix(cell["traffic"]), e2e, layer, seed=args.seed,
                 seconds=args.seconds, traced=bool(args.trace),
                 device=torch.device("cuda", 0), chips=cell["chips"])
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
