"""Share of the profiled slice's wall time in which no device operation
ran: one minus busy over wall."""


def read(t: dict):
    p = t["profile"]
    if p is None or p["wall_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["wall_s"]
