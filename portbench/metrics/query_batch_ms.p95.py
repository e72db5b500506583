"""95th percentile, over every batch of the window, of the host time from
handing a batch to the query to its per-read counts on the host (one
client, closed loop)."""

import numpy as np


def read(ctx):
    if ctx.kind != "query" or not ctx.steps:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
