"""Conservative steps a counting insert launches (``count.steps``: the
closed form and every replay round) per call (``calls.insert_seq``), from
the counts the port took while the profiler ran, which is the traced
window alone (``spans.profiled_counts``); a port that keeps no such counts
reads nothing."""

from portbench import spans


def read(ctx):
    if ctx.kind != "build" or ctx.trace is None:
        return None
    counts = spans.profiled_counts() or {}
    steps, calls = counts.get("count.steps"), counts.get("calls.insert_seq")
    if not steps or not calls:
        return None
    return steps / calls
