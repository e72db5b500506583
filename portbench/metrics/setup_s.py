"""Seconds from the start of ``run.py`` to the first timed batch: imports,
CUDA start, the kernel library (built on a checkout's first run), the
inputs made from the seed, any fill, and the warm-up."""


def read(ctx):
    return ctx.setup_s
