"""Share of the traced window in which no kernel runs on the card. Copies
count as idle: the SMs wait through them."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "query" or t is None or t.kernel_s <= 0:
        return None
    return 100.0 * (1.0 - t.kernel_s / t.window_s)
