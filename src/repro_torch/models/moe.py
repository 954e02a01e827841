"""Fine-grained MoE with shared experts (DeepSeekMoE / Kimi-K2 style).

PyTorch port of ``repro.models.moe``.  Sort-based capacity dispatch (no
[T, E] one-hots): the (token, expert) assignments are sorted by expert id,
each expert gathers its first ``capacity`` slots, overflow assignments are
dropped.  Peak memory stays at E*cap*D = T*k*cf*D.

Routing is written so that it is the reference's on every device:

* top-k is a STABLE descending sort of the router probabilities (the
  lower expert index wins a tie, as ``lax.top_k`` does; ``torch.topk``
  promises no order among equal values);
* the assignment sort is ``argsort(stable=True)`` (``jnp.argsort`` is
  stable) and the expert starts are ``searchsorted`` on the left side;
* the router runs in float32 whatever the compute dtype.

The reference's expert-parallel sharding hint (``_ep``,
``REPRO_MOE_EP`` / ``REPRO_MOE_CAP_SHARD``) is a no-op without a device
mesh and is not ported (ROADMAP.md, "Modules to port", item 6).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .layers import ninit


def init_moe_block(seed, path, cfg, dtype, device):
    """One MoE block's parameters (the router always float32)."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    Fs = cfg.n_shared_experts * Fe
    out_scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    p = {
        "router": ninit(seed, f"{path}/router", (D, E), 0.02, torch.float32,
                        device),
        "wg": ninit(seed, f"{path}/wg", (E, D, Fe), 0.02, dtype, device),
        "wu": ninit(seed, f"{path}/wu", (E, D, Fe), 0.02, dtype, device),
        "wd": ninit(seed, f"{path}/wd", (E, Fe, D), out_scale, dtype, device),
    }
    if Fs:
        p.update(
            shared_wg=ninit(seed, f"{path}/swg", (D, Fs), 0.02, dtype,
                            device),
            shared_wu=ninit(seed, f"{path}/swu", (D, Fs), 0.02, dtype,
                            device),
            shared_wd=ninit(seed, f"{path}/swd", (Fs, D), out_scale, dtype,
                            device),
        )
    return p


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: ``ceil(T * k / E * cf)`` rounded up to a multiple
    of 4, at least 4."""
    cap = int(np.ceil(tokens * top_k / n_experts * capacity_factor))
    return max(4, -(-cap // 4) * 4)


def route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Router probabilities [T, E] (float32) and the renormalised top-k
    weights and expert ids [T, k] (ids in descending probability, the
    lower id first on a tie)."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :k], idx[:, :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, topv, topi


def sort_dispatch(topi: torch.Tensor, topv: torch.Tensor, n_experts: int,
                  cap: int):
    """The sort-based capacity dispatch of ``T`` tokens' top-k assignments.

    Returns ``(order, starts, tok_idx, w, valid)``: the stable sort of the
    flattened assignments by expert, each expert's first sorted position,
    and per slot [E, cap] its token (0 where empty), weight (0.0 where
    empty) and whether it holds an assignment."""
    T, k = topi.shape
    dev = topi.device
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // k
    sorted_w = topv.reshape(-1)[order]
    experts = torch.arange(n_experts, device=dev)
    starts = torch.searchsorted(sorted_e, experts)
    slot = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    slot_c = slot.clamp(0, T * k - 1)
    valid = (sorted_e[slot_c] == experts[:, None]) & (slot < T * k)
    tok_idx = torch.where(valid, sorted_tok[slot_c], 0)
    w = torch.where(valid, sorted_w[slot_c], torch.zeros((), device=dev,
                                                         dtype=topv.dtype))
    return order, starts, tok_idx, w, valid


def assignment_slots(topi: torch.Tensor, order: torch.Tensor,
                     starts: torch.Tensor, cap: int) -> torch.Tensor:
    """[T, k] flat slot (``e * cap + c``) of each token's assignments, or
    ``E * cap`` where capacity dropped it: the gather through the inverse
    of the dispatch permutation."""
    T, k = topi.shape
    E = starts.shape[0]
    flat_e = topi.reshape(-1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    slot_of = inv - starts[flat_e]
    in_cap = slot_of < cap
    return torch.where(in_cap, flat_e * cap + slot_of.clamp(0, cap - 1),
                       E * cap).reshape(T, k)


def _shared(params, xt):
    h = F.silu(xt @ params["shared_wg"]) * (xt @ params["shared_wu"])
    return h @ params["shared_wd"]


def moe_forward(cfg, params, x):
    """x: [B, S, D] -> ([B, S, D], aux load-balance loss).

    ``REPRO_MOE_COMBINE=scatter`` combines by a scatter-add to token space
    (``index_add_``, whose order of duplicate adds is not fixed on a CUDA
    device) instead of the default gather through the inverse
    permutation."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, topv, topi = route(params["router"], xt, k)

    # aux load-balance loss (Switch-style)
    me = probs.mean(0)
    ce = torch.bincount(topi.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)

    cap = capacity(T, k, E, cfg.capacity_factor)
    order, starts, tok_idx, w, _ = sort_dispatch(topi, topv, E, cap)
    xe = xt[tok_idx]                                          # [E, cap, D]
    h = torch.einsum("ecd,edf->ecf", xe, params["wg"])
    u = torch.einsum("ecd,edf->ecf", xe, params["wu"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * u, params["wd"])

    if os.environ.get("REPRO_MOE_COMBINE", "gather") == "scatter":
        yt = torch.zeros((T, D), dtype=ye.dtype, device=ye.device)
        yt = yt.index_add(0, tok_idx.reshape(-1),
                          (ye * w[..., None].to(ye.dtype)).reshape(-1, D))
    else:
        flat_idx = assignment_slots(topi, order, starts, cap).reshape(-1)
        in_cap = flat_idx < E * cap
        yg = ye.reshape(E * cap, D)[flat_idx.clamp(max=E * cap - 1)]
        wg_ = torch.where(in_cap, topv.reshape(-1),
                          torch.zeros((), device=x.device))
        yt = (yg * wg_[:, None].to(ye.dtype)).reshape(T, k, D).sum(1)

    if "shared_wg" in params:
        yt = yt + _shared(params, xt)
    return yt.reshape(B, S, D), aux


def moe_forward_dense_ref(cfg, params, x):
    """O(T*E) oracle: every expert on every token, weighted by the router
    (same top-k mask).  For correctness tests on tiny configs."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    probs, topv, topi = route(params["router"], xt, cfg.top_k)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)
    h = torch.einsum("td,edf->tef", xt, params["wg"])
    u = torch.einsum("td,edf->tef", xt, params["wu"])
    ye = torch.einsum("tef,efd->ted", F.silu(h) * u, params["wd"])
    yt = torch.einsum("te,ted->td", gates.to(ye.dtype), ye)
    if "shared_wg" in params:
        yt = yt + _shared(params, xt)
    return yt.reshape(B, S, D)
