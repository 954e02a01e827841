"""Share of a step's supersteps run in overlap ticks (hidden behind the
step's compute) rather than in barrier ticks, from the runtime's counters."""


def read(t: dict):
    if not t["supersteps"]:
        return None
    return t["overlap_supersteps"] / t["supersteps"]
