"""Seconds of a step outside the runtime's calls (model, optimizer, the
MoE's dispatch, experts and combine, packing): the window less every
outermost program span, over the window's steps."""


def read(t: dict):
    if not t["steps"]:
        return None
    return (t["window_s"] - t["spans"]["runtime"]) / t["steps"]
