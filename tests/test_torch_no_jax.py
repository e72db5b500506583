"""The port must run where JAX is not installed: importing it, its API,
its CLIs, its distribution layer, the rank launcher, the blocked filter
and the Perl bridge's worker pulls in neither jax nor the JAX package, and
no file of the port builds a path into the JAX package's directory."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = (
    "btl_bloomfilter_tpu_torch", "btl_bloomfilter_tpu_torch.api",
    "btl_bloomfilter_tpu_torch.tools.write_bloom",
    "btl_bloomfilter_tpu_torch.tools.test_bloom",
    "btl_bloomfilter_tpu_torch.io.bf_format",
    "btl_bloomfilter_tpu_torch.models.counting",
    "btl_bloomfilter_tpu_torch.kernels.gather_counters",
    "btl_bloomfilter_tpu_torch.kernels.scatter_add",
    "btl_bloomfilter_tpu_torch.kernels.tile_partition",
    "btl_bloomfilter_tpu_torch.kernels.conservative_step",
    "btl_bloomfilter_tpu_torch.kernels.mibf_rank",
    "btl_bloomfilter_tpu_torch.kernels.mibf_frame_scan",
    "btl_bloomfilter_tpu_torch.models.mibf",
    "btl_bloomfilter_tpu_torch.models.mibf_construct",
    "btl_bloomfilter_tpu_torch.models.mibf_query",
    "btl_bloomfilter_tpu_torch.io.mibf_format",
    "btl_bloomfilter_tpu_torch.io.sdsl",
    "btl_bloomfilter_tpu_torch.tools.build_mibf",
    "btl_bloomfilter_tpu_torch.tools.classify",
    "btl_bloomfilter_tpu_torch.native",
    "btl_bloomfilter_tpu_torch.kernels.scatter_ring",
    "btl_bloomfilter_tpu_torch.kernels.vmem_sort",
    "btl_bloomfilter_tpu_torch.kernels.window_scatter",
    "btl_bloomfilter_tpu_torch.kernels.dma_sweep",
    "btl_bloomfilter_tpu_torch.probes.ring_probe",
    "btl_bloomfilter_tpu_torch.probes.vmem_sort_probe",
    "btl_bloomfilter_tpu_torch.probes.partition_probe",
    "btl_bloomfilter_tpu_torch.probes.kernel_lab",
    "btl_bloomfilter_tpu_torch.tools.time_kernels",
    "btl_bloomfilter_tpu_torch.tools.timing",
    "btl_bloomfilter_tpu_torch.ops.seeds",
    "btl_bloomfilter_tpu_torch.utils.stdcpp",
    "btl_bloomfilter_tpu_torch.kernels.spaced_scan",
    "btl_bloomfilter_tpu_torch.kernels.mibf_random_insert",
    "btl_bloomfilter_tpu_torch.compat",
    "btl_bloomfilter_tpu_torch.utils.binomial",
    "btl_bloomfilter_tpu_torch.parallel.mesh",
    "btl_bloomfilter_tpu_torch.parallel.multihost",
    "btl_bloomfilter_tpu_torch.parallel.collectives",
    "btl_bloomfilter_tpu_torch.parallel.dist_bloom",
    "btl_bloomfilter_tpu_torch.parallel.dist_counting",
    "btl_bloomfilter_tpu_torch.parallel.dist_mibf",
    "btl_bloomfilter_tpu_torch.tools.dist_run",
    "btl_bloomfilter_tpu_torch.models.blocked",
    "btl_bloomfilter_tpu_torch.kernels.blocked_bloom",
)

# Imports MODULES and the Perl bridge's worker, then fails if jax or the
# JAX package is in sys.modules; run from a directory holding the port.
IMPORT_CHECK = (
    "import sys; "
    f"import {', '.join(MODULES)}; "
    "import importlib.util; "
    "spec = importlib.util.spec_from_file_location("
    "'bridge_server', 'swig_torch/bridge_server.py'); "
    "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
    "bad = [m for m in sys.modules if m == 'jax' or "
    "m.startswith('jax.') or m == 'btl_bloomfilter_tpu' or "
    "m.startswith('btl_bloomfilter_tpu.')]; "
    "assert not bad, bad")


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", IMPORT_CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# no path into the JAX package's directory
# ---------------------------------------------------------------------------

JAX_DIR = "btl_bloomfilter_tpu"
PATH_CLASSES = {"Path", "PurePath", "PosixPath", "PurePosixPath"}


def _strings(node):
    """The string constants of an expression node (an f-string's literal
    parts too)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, ast.JoinedStr):
        for part in node.values:
            yield from _strings(part)


def _name(func) -> str:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def jax_path_joins(source: str):
    """Line numbers of ``os.path.join`` calls and pathlib joins
    (``Path(...)`` of several parts, ``.joinpath``, ``/``) that take the
    JAX package's directory as a path component. Comments, docstrings and
    other strings are not paths and are not looked at."""
    hits = []
    for node in ast.walk(ast.parse(source)):
        parts = []
        if isinstance(node, ast.Call):
            func = node.func
            os_join = (_name(func) == "join" and (
                isinstance(func, ast.Name) or (
                    isinstance(func.value, ast.Attribute)
                    and func.value.attr == "path")))
            if (os_join or _name(func) == "joinpath"
                    or _name(func) in PATH_CLASSES):
                parts = node.args
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts = [node.left, node.right]
        for arg in parts:
            for s in _strings(arg):
                if JAX_DIR in s.replace("\\", "/").split("/"):
                    hits.append(node.lineno)
    return hits


def port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("btl_bloomfilter_tpu_torch", "swig_torch"):
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, top)):
            dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
            paths += [os.path.join(dirpath, f) for f in files
                      if f.endswith(".py")]
    return sorted(paths)


def test_port_builds_no_path_into_the_jax_package():
    paths = port_sources()
    assert len(paths) > 40
    found = {}
    for path in paths:
        with open(path) as f:
            hits = jax_path_joins(f.read())
        if hits:
            found[os.path.relpath(path, ROOT)] = hits
    assert not found, found


@pytest.mark.parametrize("source,hits", [
    ('SRC = os.path.join(os.path.dirname(_PKG), "btl_bloomfilter_tpu", '
     '"native",\n                   "fastaio.cpp")', [1]),
    ('from os.path import join\np = join(ROOT, "btl_bloomfilter_tpu/x.cpp")',
     [2]),
    ('p = pathlib.Path(ROOT) / "btl_bloomfilter_tpu" / "native"', [1]),
    ('p = Path(ROOT).joinpath(f"btl_bloomfilter_tpu/{name}")', [1]),
    ('p = Path(ROOT, "btl_bloomfilter_tpu", "native")', [1]),
    ('"""Copy of btl_bloomfilter_tpu/native/fastaio.cpp."""\n'
     'x = {"replaces": "btl_bloomfilter_tpu/kernels/nthash_scan.py:276"}\n'
     'p = os.path.join(ROOT, "btl_bloomfilter_tpu_torch", "csrc")\n'
     'q = " ".join(["btl_bloomfilter_tpu", "x"])', []),
])
def test_path_check_sees_the_pattern(source, hits):
    assert jax_path_joins(source) == hits
