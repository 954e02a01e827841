"""Milliseconds of the daemon's host-driven loop per superstep: the spans
of drive() less its staging flushes, plus the in-step ticks and tick
loops, over the supersteps of the window."""


def read(t: dict):
    sp = t["spans"]
    s = sp["drive"] - sp["flush"] + sp["tick"]
    if s <= 0 or not t["supersteps"]:
        return None
    return s * 1e3 / t["supersteps"]
