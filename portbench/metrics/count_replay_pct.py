"""Share of the valid frames the counting insert replayed in rounds
(``count.replayed_frames`` over ``count.frames``), from the counts the port
took while the profiler ran, which is the traced window alone
(``spans.profiled_counts``); a port that keeps no such counts reads
nothing."""

from portbench import spans


def read(ctx):
    if ctx.kind != "build" or ctx.trace is None:
        return None
    counts = spans.profiled_counts() or {}
    frames = counts.get("count.frames")
    if not frames:
        return None
    return 100.0 * counts.get("count.replayed_frames", 0) / frames
