"""Device ms a call in the conservative-step kernel
(``csrc/conservative_step.cu``, every kernel whose name begins with
``conservative_step``), read by name from the traced window's device
operations; nothing where the window ran no such kernel."""

KERNEL = "conservative_step"


def read(ctx):
    t = ctx.trace
    if ctx.kind != "build" or t is None or not t.calls:
        return None
    s = [sec for name, sec in t.device_ops if name.startswith(KERNEL)]
    if not s:
        return None
    return sum(s) / t.calls * 1e3
