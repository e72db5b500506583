"""Valid k-mer windows handed to the insert in the window, over the
window's seconds (from its start until the card finished the last batch)."""


def read(ctx):
    if ctx.kind != "build" or not ctx.steps:
        return None
    return ctx.work / ctx.window_s
