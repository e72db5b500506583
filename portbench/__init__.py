"""The benchmark of the PyTorch / CUDA port ``btl_bloomfilter_tpu_torch``.

``run.py`` is the command; ``BENCHMARK.json`` at the root of the checkout
names its cells. Configurations (``configs/``), traffic mixes (``mixes/``)
and metrics (``metrics/``) are found by name; ``reference/`` is the plain
yardstick the port's outputs are held to.
"""
