"""The inserts' share of their memory roofline: the least bytes any insert
must move (codes read once; each distinct filter word touched read once and
written once, 4 B + 4 B; counted by the reference from the traced batches)
over the card's HBM rate (``peaks.json``), divided by the device time of
every kernel queued inside the calls. Bound by bytes: an insert does no
arithmetic worth a compute bound."""


def read(ctx):
    t, rate = ctx.trace, ctx.peaks.get("hbm_bytes_per_s")
    if (ctx.kind != "build" or t is None or not rate or not ctx.least_bytes
            or t.call_kernel_s <= 0):
        return None
    return 100.0 * ctx.least_bytes / rate / t.call_kernel_s
