"""AdamW with global-norm clipping and a linear-warmup cosine schedule,
over flat dicts of float32 tensors; the hyperparameters are the
configuration's ``optimizer`` entry."""
from __future__ import annotations

import math

import torch


def learning_rate(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * (step + 1) / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * 0.5 * (1.0 + math.cos(math.pi * prog))


def step(opt: dict, params: dict, grads: dict, m: dict, v: dict,
         t: int) -> tuple[dict, dict, dict]:
    """One update at step ``t`` (0-based); returns new (params, m, v)."""
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in grads.values()))
    scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
    lr = learning_rate(opt, t)
    b1, b2 = opt["beta1"], opt["beta2"]
    bc1, bc2 = 1.0 - b1 ** (t + 1), 1.0 - b2 ** (t + 1)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k] * scale
        mk = b1 * m[k] + (1 - b1) * g
        vk = b2 * v[k] + (1 - b2) * g * g
        u = (mk / bc1) / (torch.sqrt(vk / bc2) + opt["eps"])
        new_p[k] = p - lr * (u + opt["weight_decay"] * p)
        new_m[k], new_v[k] = mk, vk
    return new_p, new_m, new_v
