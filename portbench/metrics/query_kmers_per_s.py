"""Valid k-mer windows queried, with each batch's per-read counts on the
host, over the window's seconds."""


def read(ctx):
    if ctx.kind != "query" or not ctx.steps:
        return None
    return ctx.work / ctx.window_s
