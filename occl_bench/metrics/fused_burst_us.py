"""Mean device microseconds of one ``fused_burst_kernel`` launch on the
profiled slice.  A time, not a roofline share: under the daemon's graph
replay the lanes a launch moves are not visible to the harness, so no byte
count of the launches it timed can be made.  Nothing to read where no
launch was traced."""


def read(t: dict):
    p = t["profile"]
    if p is None or not p["burst_mean_s"]:
        return None
    return p["burst_mean_s"] * 1e6
