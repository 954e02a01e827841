"""One expert-parallel MoE layer: its weights and tokens drawn from the
seed, its forward's FLOPs, the reference's outputs, the stand-in (the
control alone: a forward keeps no state) and its tiny CPU configuration.

``ref`` is the configuration's reference module
(``reference/<reference>.py``): ``param_shapes``, ``capacity`` and
``layer``.
"""
from __future__ import annotations

import torch

from ..harness import compare
from ..harness.feed import generator
from ..reference import numerics

KINDS = ("control",)


def capacity(cfg: dict, ref) -> int:
    """Slots per (rank, expert) at the cell's tokens per rank."""
    return ref.capacity(cfg["deployment"]["tokens_per_rank"],
                        cfg["num_experts_per_tok"], cfg["n_routed_experts"],
                        cfg["capacity_factor"])


def params(cfg: dict, seed: int, device, ref) -> dict:
    """The MoE layer's float32 leaves: std 0.02, the two down projections
    0.02 / sqrt(2 x the published depth)."""
    depth = cfg["published"].get("num_hidden_layers",
                                 cfg["num_hidden_layers"])
    down = 0.02 / (2 * depth) ** 0.5
    out = {}
    for name, shape in ref.param_shapes(cfg).items():
        std = down if name in ("wd", "shared_wd") else 0.02
        out[name] = torch.randn(shape, generator=generator(device, seed,
                                                           "moe", name),
                                device=device) * std
    return out


def tokens(cfg: dict, seed: int, step, device) -> list:
    """R [T, D] token matrices of one step: normals plus
    ``token_shared_direction`` times one shared direction, so the router's
    load is uneven and capacity drops real assignments.  Copied from
    ``chip_smoke.py:1637-1645`` (``moe_tokens``)."""
    dep = cfg["deployment"]
    g = generator(device, seed, "tokens", step)
    x = torch.randn((dep["ep_ranks"], dep["tokens_per_rank"],
                     cfg["hidden_size"]), generator=g, device=device)
    shared = torch.randn((cfg["hidden_size"],), generator=g, device=device)
    return list(x + dep["token_shared_direction"] * shared)


def step_flops(cfg: dict) -> int:
    """One MoE layer's forward over every rank's tokens: the router, each
    token's ``num_experts_per_tok`` routed SwiGLU experts and the shared
    experts (three products of ``hidden_size`` by the expert width each; a
    product of [m, k] by [k, n] counts 2*m*k*n)."""
    dep = cfg["deployment"]
    T = dep["ep_ranks"] * dep["tokens_per_rank"]
    D, Fe = cfg["hidden_size"], cfg["moe_intermediate_size"]
    router = 2 * T * D * cfg["n_routed_experts"]
    routed = T * cfg["num_experts_per_tok"] * 3 * 2 * D * Fe
    shared = T * 3 * 2 * D * (cfg["n_shared_experts"] * Fe)
    return router + routed + shared


def reference_outputs(cfg: dict, params: dict, xs: list, cap: int, ref,
                      control: bool = False) -> list:
    """Every rank's reference output: float64 experts, or for the control
    TF32 operands in every product and float32 experts."""
    with numerics.matmul_precision(tf32=False):
        if control:
            return [ref.layer(cfg, params, x, cap, torch.float32,
                              numerics.tf32) for x in xs]
        return [ref.layer(cfg, params, x, cap) for x in xs]


def out_gap(cfg: dict, params: dict, steps, seed: int, device, ref) -> dict:
    """The widest output gap over ``steps`` (step, [R, T, D] outputs)
    against the reference on that step's tokens."""
    cap = capacity(cfg, ref)
    gap = 0.0
    for s, got in steps:
        want = reference_outputs(cfg, params, tokens(cfg, seed, s, device),
                                 cap, ref)
        gap = max([gap] + [compare.output_gap(g, w)
                           for g, w in zip(got, want)])
    return {"out_gap": gap}


def standin(cfg: dict, wl: dict, seed: int, device, kind: str, ref) -> dict:
    """The control's reading (TF32 operands, float32 experts) on one
    step's tokens."""
    cap = capacity(cfg, ref)
    p = params(cfg, seed, device, ref)
    xs = tokens(cfg, seed, 0, device)
    got = reference_outputs(cfg, p, xs, cap, ref, control=True)
    return out_gap(cfg, p, [(0, got)], seed, device, ref)


def tiny(cfg: dict, wl: dict) -> tuple[dict, dict]:
    """The configuration and workload cut so that a cell's whole run takes
    seconds on the CPU."""
    cfg.update(hidden_size=64, n_routed_experts=8, num_experts_per_tok=2,
               n_shared_experts=1, moe_intermediate_size=32)
    cfg["port"]["overrides"].update(d_model=64, n_experts=8, top_k=2,
                                    n_shared_experts=1, d_ff_expert=32)
    cfg["deployment"].update(tokens_per_rank=16, slice_elems=512,
                             n_streams=2, overlap_ticks=4)
    if wl.get("mode") == "overlap":
        wl["warm_ticks"] = [4, 8, 16]
    return cfg, wl
