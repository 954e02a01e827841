"""Seconds a step spends in the runtime's staging flush and bulk output
reads: host-clock spans, each ended by a device sync."""


def read(t: dict):
    s = t["spans"]["flush"] + t["spans"]["read"]
    if not s or not t["steps"]:
        return None
    return s / t["steps"]
