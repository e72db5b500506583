"""The queries' share of their memory roofline: the least bytes any query
must move (codes read once; for each valid window the filter words up to
and including its first clear bit, all h on a hit, 4 B each; one bool a
window written; counted by the reference from the traced batches) over the
card's HBM rate (``peaks.json``), divided by the device time of every
kernel queued inside the calls."""


def read(ctx):
    t, rate = ctx.trace, ctx.peaks.get("hbm_bytes_per_s")
    if (ctx.kind != "query" or t is None or not rate or not ctx.least_bytes
            or t.call_kernel_s <= 0):
        return None
    return 100.0 * ctx.least_bytes / rate / t.call_kernel_s
