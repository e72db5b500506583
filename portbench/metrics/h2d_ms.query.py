"""Device time of the host-to-device copies queued inside the port's
calls (``kmer_bloom._codes_on``: a pageable numpy batch to the card), per
call, from the profiler's trace of the window."""


def read(ctx):
    t = ctx.trace
    if ctx.kind != "query" or t is None or not t.calls:
        return None
    return t.call_h2d_s / t.calls * 1e3
