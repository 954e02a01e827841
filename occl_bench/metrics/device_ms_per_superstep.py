"""Device-busy milliseconds per superstep on the profiled slice: the union
of the device's kernel and copy intervals, over the slice's supersteps."""


def read(t: dict):
    p = t["profile"]
    if p is None or not p["supersteps"]:
        return None
    return p["busy_s"] * 1e3 / p["supersteps"]
