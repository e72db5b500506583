"""Hashing primitives (ntHash constants, unsigned int64 helpers, ntHash)
and the round schedule of order-dependent replays."""
