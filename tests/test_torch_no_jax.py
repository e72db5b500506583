"""The port must run where JAX is not installed: importing it, its API,
its CLIs, its distribution layer, the rank launcher, the blocked filter
and the Perl bridge's worker pulls in neither jax nor the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = ("import sys; "
            "import btl_bloomfilter_tpu_torch, btl_bloomfilter_tpu_torch.api, "
            "btl_bloomfilter_tpu_torch.tools.write_bloom, "
            "btl_bloomfilter_tpu_torch.tools.test_bloom, "
            "btl_bloomfilter_tpu_torch.io.bf_format, "
            "btl_bloomfilter_tpu_torch.models.counting, "
            "btl_bloomfilter_tpu_torch.kernels.gather_counters, "
            "btl_bloomfilter_tpu_torch.kernels.scatter_add, "
            "btl_bloomfilter_tpu_torch.kernels.tile_partition, "
            "btl_bloomfilter_tpu_torch.kernels.conservative_step, "
            "btl_bloomfilter_tpu_torch.kernels.mibf_rank, "
            "btl_bloomfilter_tpu_torch.kernels.mibf_frame_scan, "
            "btl_bloomfilter_tpu_torch.models.mibf, "
            "btl_bloomfilter_tpu_torch.models.mibf_construct, "
            "btl_bloomfilter_tpu_torch.models.mibf_query, "
            "btl_bloomfilter_tpu_torch.io.mibf_format, "
            "btl_bloomfilter_tpu_torch.io.sdsl, "
            "btl_bloomfilter_tpu_torch.tools.build_mibf, "
            "btl_bloomfilter_tpu_torch.tools.classify, "
            "btl_bloomfilter_tpu_torch.native, "
            "btl_bloomfilter_tpu_torch.kernels.scatter_ring, "
            "btl_bloomfilter_tpu_torch.kernels.vmem_sort, "
            "btl_bloomfilter_tpu_torch.kernels.window_scatter, "
            "btl_bloomfilter_tpu_torch.kernels.dma_sweep, "
            "btl_bloomfilter_tpu_torch.probes.ring_probe, "
            "btl_bloomfilter_tpu_torch.probes.vmem_sort_probe, "
            "btl_bloomfilter_tpu_torch.probes.partition_probe, "
            "btl_bloomfilter_tpu_torch.probes.kernel_lab, "
            "btl_bloomfilter_tpu_torch.tools.time_kernels, "
            "btl_bloomfilter_tpu_torch.tools.timing, "
            "btl_bloomfilter_tpu_torch.ops.seeds, "
            "btl_bloomfilter_tpu_torch.utils.stdcpp, "
            "btl_bloomfilter_tpu_torch.kernels.spaced_scan, "
            "btl_bloomfilter_tpu_torch.kernels.mibf_random_insert, "
            "btl_bloomfilter_tpu_torch.compat, "
            "btl_bloomfilter_tpu_torch.utils.binomial, "
            "btl_bloomfilter_tpu_torch.parallel.mesh, "
            "btl_bloomfilter_tpu_torch.parallel.multihost, "
            "btl_bloomfilter_tpu_torch.parallel.collectives, "
            "btl_bloomfilter_tpu_torch.parallel.dist_bloom, "
            "btl_bloomfilter_tpu_torch.parallel.dist_counting, "
            "btl_bloomfilter_tpu_torch.parallel.dist_mibf, "
            "btl_bloomfilter_tpu_torch.tools.dist_run, "
            "btl_bloomfilter_tpu_torch.models.blocked, "
            "btl_bloomfilter_tpu_torch.kernels.blocked_bloom; "
            "import importlib.util; "
            "spec = importlib.util.spec_from_file_location("
            "'bridge_server', 'swig_torch/bridge_server.py'); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'btl_bloomfilter_tpu' or "
            "m.startswith('btl_bloomfilter_tpu.')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
