"""The reference put in the program's place: the control (one precision
below the configuration's) and the faults a cell can have, read by the
same comparison as the program (``calibrate.py`` reads them on the card
at the cells' sizes; the tests at a small size)."""
from __future__ import annotations

from ..reference import numerics
from . import compare, drivers, feed

VIT_KINDS = ("control", "unchanged", "half_batch", "no_exchange",
             "answer_altered")
MOE_KINDS = ("control",)


def vit(cfg: dict, seed: int, device, kind: str, steps: int) -> dict:
    params = feed.vit_params(cfg, seed, device)
    vfeed = feed.VitFeed(cfg, seed, device)
    ref = drivers.vit_reference(cfg, params, vfeed, steps)
    if kind == "control":
        alt = drivers.vit_reference(cfg, params, vfeed, steps,
                                    quant=numerics.fp8)
    else:
        alt = drivers.vit_reference(cfg, params, vfeed, steps, fault=kind)
    R = cfg["deployment"]["dp_ranks"]
    prog = {"losses": alt["losses"], "m1": [alt["m1"]] * R,
            "pn": [alt["pn"]] * R}
    return compare.training(prog, ref, params)


def moe(cfg: dict, seed: int, device, kind: str, steps: int) -> dict:
    dep = cfg["deployment"]
    cap = drivers.ref_moe.capacity(dep["tokens_per_rank"],
                                   cfg["num_experts_per_tok"],
                                   cfg["n_routed_experts"],
                                   cfg["capacity_factor"])
    params = feed.moe_params(cfg, seed, device)
    gap = 0.0
    for s in range(steps):
        xs = feed.moe_tokens(cfg, seed, s, device)
        want = drivers.moe_reference(cfg, params, xs, cap)
        got = drivers.moe_reference(cfg, params, xs, cap, control=True)
        gap = max([gap] + [compare.output_gap(g, w)
                           for g, w in zip(got, want)])
    return {"out_gap": gap}


def read(cfg: dict, wl: dict, seed: int, device, kind: str) -> dict:
    if cfg["family"] == "vit":
        return vit(cfg, seed, device, kind, drivers.CHECKED_STEPS)
    return moe(cfg, seed, device, kind, 1)


def kinds(cfg: dict) -> tuple:
    return VIT_KINDS if cfg["family"] == "vit" else MOE_KINDS
