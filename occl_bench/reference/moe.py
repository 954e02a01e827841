"""One rank's share of an expert-parallel MoE layer: the router, the
capacity rule and the routed and shared SwiGLU experts, in plain PyTorch.

Expert parallelism only moves tokens to their experts and back, so the
layer's output on a rank's tokens is the plain MoE layer on those tokens:
softmax router scores in float32 (``x @ router``), the top-k taken in
descending score with the lower expert first on a tie and renormalised to
sum to one, each (rank, expert) pair keeping its first ``cap`` assignments
in token order, each kept assignment adding its weight times the expert's
SwiGLU output, and the shared experts added to every token.  ``dtype`` is
the experts' arithmetic (float64 for the check, float32 for the control);
``quant`` rounds both operands of every product (the control's TF32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import exact


def route(router, x, top_k: int, quant=exact):
    """[T, k] renormalised weights and expert ids."""
    probs = torch.softmax(quant(x.float()) @ quant(router.float()), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w = vals[:, :top_k]
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx[:, :top_k]


def kept(experts: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """[T*k] bool: whether each assignment (token-major) is among its
    expert's first ``cap`` in that order."""
    n = experts.numel()
    order = torch.argsort(experts, stable=True)
    first = torch.searchsorted(experts[order],
                               torch.arange(n_experts, device=experts.device))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(n, device=experts.device) - first[experts[order]]
    return pos < cap


def capacity(tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots per (rank, expert): ``ceil(T * k / E * factor)`` up to a
    multiple of 4, at least 4."""
    c = math.ceil(tokens * top_k / n_experts * factor)
    return max(4, -(-c // 4) * 4)


def layer(cfg: dict, p: dict, x, cap: int, dtype=torch.float64,
          quant=exact):
    """[T, D] output of the layer on one rank's tokens ``x``."""
    T, D = x.shape
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    w, e = route(p["router"], x, k, quant)
    mm = lambda a, b: quant(a) @ quant(b.to(dtype))
    flat_e = e.reshape(-1)
    keep = kept(flat_e, E, cap)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_w = w.reshape(-1)
    xd = x.to(dtype)
    y = torch.zeros((T, D), dtype=dtype, device=x.device)
    for ex in range(E):
        sel = keep & (flat_e == ex)
        t = tok[sel]
        if t.numel() == 0:
            continue
        xe = xd[t]
        h = F.silu(mm(xe, p["wg"][ex])) * mm(xe, p["wu"][ex])
        y.index_add_(0, t, mm(h, p["wd"][ex]) * flat_w[sel].to(dtype)[:, None])
    hs = F.silu(mm(xd, p["shared_wg"])) * mm(xd, p["shared_wu"])
    return y + mm(hs, p["shared_wd"])


def param_shapes(cfg: dict) -> dict:
    D, E, Fe = cfg["hidden_size"], cfg["n_routed_experts"], \
        cfg["moe_intermediate_size"]
    Fs = cfg["n_shared_experts"] * Fe
    return {"router": (D, E), "wg": (E, D, Fe), "wu": (E, D, Fe),
            "wd": (E, Fe, D), "shared_wg": (D, Fs), "shared_wu": (D, Fs),
            "shared_wd": (Fs, D)}
