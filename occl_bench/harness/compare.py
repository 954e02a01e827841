"""The comparison that decides ``correct``: readings of the program
against the plain reference, and the limits they are held to.

Training cells (``training``): each checked step's loss; the norm of the
first gradient as the optimizer got it, worked out from its first moment
after one step; the norm of the parameters' change after the checked
steps.  Norms are compared leaf by leaf: the gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf; the worst leaf and rank is the reading.
Leaves whose reference gradient is under a thousandth of the median leaf's
(nought to rounding) are left out of the change.

MoE cells (``outputs``): the widest gap of any output element, over the
largest reference output of that rank.
"""
from __future__ import annotations

import math
import statistics

import torch

STILL = 1e-3     # a leaf whose gradient norm is under STILL x the median's


def norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def norm_gap(prog: dict, ref: dict, keys=None) -> float:
    keys = list(ref) if keys is None else list(keys)
    pn, rn = norms({k: prog[k] for k in keys}), norms({k: ref[k]
                                                        for k in keys})
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def training(prog: dict, ref: dict, p0: dict) -> dict:
    """``prog``: per rank ``losses`` [steps][ranks] (floats), ``m1`` and
    ``pn`` (flat dicts per rank); ``ref``: the same for the reference
    (one ``m1`` / ``pn``, as every rank holds the same average) plus
    ``g0``, its averaged first gradient."""
    loss_gap = max(abs(lp - lr) / abs(lr)
                   for sp, sr in zip(prog["losses"], ref["losses"])
                   for lp, lr in zip(sp, sr))
    grad_gap = max(norm_gap(m, ref["m1"]) for m in prog["m1"])
    gn = norms(ref["g0"])
    med = statistics.median(gn.values())
    moving = [k for k, n in gn.items() if n >= STILL * med]
    dref = {k: ref["pn"][k] - p0[k] for k in moving}
    upd_gap = max(norm_gap({k: p[k] - p0[k] for k in moving}, dref)
                  for p in prog["pn"])
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "update_norm_gap": upd_gap}


def output_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Widest |got - want| over the largest |want|, of one rank."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Every limited reading finite and within its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
