"""AdamW with global-norm clipping and a warmup-cosine schedule.

PyTorch port of ``repro.optim.adamw`` over
nested-dict trees of tensors, float32 arithmetic as in the reference, and
its ZeRO-1 moment partitioning (:func:`zero1_pspecs`: moments sharded over
the "data" axis on top of the tensor-parallel parameter specs).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.sharding import P
from ..tree import tree_leaves, tree_map, tree_unflatten


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an int32 tensor), float32."""
    warm = cfg.lr * (step + 1).float() / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos).float()


def init_moments(params, moment_dtype: str):
    dt = getattr(torch, moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, params, grads, m, v, step, *,
                 inplace: bool = False):
    """One AdamW step; returns (params, m, v, grad norm).  With
    ``inplace`` the new values are written into ``params``, ``m`` and
    ``v`` themselves, one leaf at a time (the same values; a state is
    then never held twice), and those trees are returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).float()
    bc1 = 1.0 - cfg.beta1 ** t
    bc2 = 1.0 - cfg.beta2 ** t

    def upd(p, g, mi, vi):
        gf = g.float() * scale
        mn = cfg.beta1 * mi.float() + (1 - cfg.beta1) * gf
        vn = cfg.beta2 * vi.float() + (1 - cfg.beta2) * gf * gf
        u = (mn / bc1) / (torch.sqrt(vn / bc2) + cfg.eps)
        pf = p.float()
        pn = pf - lr * (u + cfg.weight_decay * pf)
        return pn.to(p.dtype), mn.to(mi.dtype), vn.to(vi.dtype)

    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(m),
                 tree_leaves(v))
    if inplace:
        for p, g, mi, vi in leaves:
            for old, new in zip((p, mi, vi), upd(p, g, mi, vi)):
                old.copy_(new)
        return params, m, v, gnorm
    out = [upd(*xs) for xs in leaves]
    return (tree_unflatten(params, [o[0] for o in out]),
            tree_unflatten(m, [o[1] for o in out]),
            tree_unflatten(v, [o[2] for o in out]), gnorm)


def zero1_pspecs(param_pspecs, params, data_size: int = 16):
    """ZeRO-1: additionally shard each moment leaf's first large,
    still-replicated, divisible dim over the "data" axis."""
    def z(spec, p):
        dims = list(spec) + [None] * (p.ndim - len(spec))
        for i, d in enumerate(dims):
            if d is None and p.shape[i] % data_size == 0 \
                    and p.shape[i] >= data_size:
                dims[i] = "data"
                return P(*dims)
        return P(*dims)

    return tree_map(z, param_pspecs, params)
