"""Daemon supersteps a step takes: the runtime's superstep clock (its
maximum over ranks) across the window, over the window's steps."""


def read(t: dict):
    if not t["steps"]:
        return None
    return t["supersteps"] / t["steps"]
