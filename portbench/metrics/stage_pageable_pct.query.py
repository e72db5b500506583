"""Share of the bytes the port staged (its ``stage_bytes.*`` counts) that
came from pageable host memory, in a traced run on the card. The counts are
the ones the port took while the profiler ran, which is the window alone
(``spans.profiled_counts``); a port that keeps no such counts reads
nothing."""

from portbench import spans


def read(ctx):
    if ctx.kind != "query" or ctx.trace is None:
        return None
    return spans.pageable_pct(spans.profiled_counts())
