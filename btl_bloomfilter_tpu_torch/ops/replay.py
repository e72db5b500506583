"""Round schedule of an order-dependent replay: frames that share a position
must apply in stream order, frames that share none may apply together.

Used by the counting filter's conservative update (positions are filter
positions) and by the MIBF build's phase 4 (positions are ranks).
"""

from __future__ import annotations

import torch

STREAM_BITS = 31                # frame index bits of a (position, frame) key
STREAM_MASK = (1 << STREAM_BITS) - 1


def replay_depth(p: torch.Tensor) -> torch.Tensor:
    """Round of each frame of p int64 [h, m] (positions < 2**32 of live
    frames in stream order): any two frames that share a position get
    strictly increasing rounds in stream order, so the frames of one round
    are position-disjoint and the rounds in order reproduce stream order.
    Computed as the fixpoint of round[f] >= round[previous user of each
    position of f] + 1, one iteration per link of the longest chain."""
    h, m = p.shape
    if m >= (1 << STREAM_BITS):
        raise ValueError(f"{m} frames to replay; at most 2**31 - 1")
    frame = torch.arange(m, device=p.device).repeat(h)
    key, _ = torch.sort((p.reshape(-1) << STREAM_BITS) | frame)
    pos_s, frame_s = key >> STREAM_BITS, key & STREAM_MASK
    # no self-edges: a frame's own duplicate positions impose no order
    edge = (pos_s[1:] == pos_s[:-1]) & (frame_s[1:] != frame_s[:-1])
    src, dst = frame_s[:-1][edge], frame_s[1:][edge]
    depth = torch.ones(m, dtype=torch.int64, device=p.device)
    while True:
        new = depth.scatter_reduce(0, dst, depth[src] + 1, "amax")
        if torch.equal(new, depth):
            return depth
        depth = new
