"""The step's model FLOPs (roofline/flops.py, no recomputation counted) per
second of the traced run's step, as a share of the card's dense peak in
the precision the step's products run in (the configuration's)."""


def read(t: dict):
    if not t["steps"] or t["window_s"] <= 0:
        return None
    step_s = t["window_s"] / t["steps"]
    return 100.0 * t["step_flops"] / step_s / t["peak_flops_per_s"]
