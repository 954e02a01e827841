"""The port's ViT classifier, trained data-parallel: forward, loss and
gradients in plain PyTorch.

Parameters are a flat dict keyed by the port's tree paths (``layers/attn/wq``
...), each layer's leaves stacked on a leading axis.  The model is the one
``configs/vit-base-dp4.json`` describes, departures included: RMSNorm
(``1 + w``, eps 1e-6) before attention, LayerNorm before the tanh-GELU MLP,
no CLS token (mean-pooled after a final RMSNorm), no q / k / v bias, a class
head padded to a multiple of ``vocab_pad`` with the padded logits masked.
``quant`` rounds both operands of every linear product (the control's float8
products); the attention products stay in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import exact


def padded_classes(cfg: dict) -> int:
    pad = cfg["port"]["vocab_pad"]
    return -(-cfg["num_labels"] // pad) * pad


def param_shapes(cfg: dict) -> dict:
    """Flat parameter name -> shape."""
    D, L, F_ = cfg["hidden_size"], cfg["num_hidden_layers"], \
        cfg["intermediate_size"]
    HD = cfg["num_attention_heads"] * cfg["head_dim"]
    return {
        "final_norm": (D,),
        "head": (D, padded_classes(cfg)),
        "layers/attn/norm": (L, D),
        "layers/attn/wk": (L, D, HD),
        "layers/attn/wo": (L, HD, D),
        "layers/attn/wq": (L, D, HD),
        "layers/attn/wv": (L, D, HD),
        "layers/mlp/b1": (L, F_),
        "layers/mlp/b2": (L, D),
        "layers/mlp/norm_b": (L, D),
        "layers/mlp/norm_w": (L, D),
        "layers/mlp/w1": (L, D, F_),
        "layers/mlp/w2": (L, F_, D),
        "patch_proj": (D, D),
        "pos_embed": (cfg["num_patches"], D),
    }


def rms_norm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def layer_norm(x, w, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def loss(cfg: dict, p: dict, patches, labels, quant=exact):
    """Mean cross-entropy of one rank's batch ([B, T, D] patches, [B]
    labels)."""
    q = quant
    H, dh = cfg["num_attention_heads"], cfg["head_dim"]
    lin = lambda x, w: q(x) @ q(w)
    x = lin(patches, p["patch_proj"]) + p["pos_embed"]
    B, T, _ = x.shape
    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, p["layers/attn/norm"][i])
        qh = lin(h, p["layers/attn/wq"][i]).view(B, T, H, dh)
        kh = lin(h, p["layers/attn/wk"][i]).view(B, T, H, dh)
        vh = lin(h, p["layers/attn/wv"][i]).view(B, T, H, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
        a = torch.softmax(s, dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", a, vh).reshape(B, T, H * dh)
        x = x + lin(y, p["layers/attn/wo"][i])
        h = layer_norm(x, p["layers/mlp/norm_w"][i],
                       p["layers/mlp/norm_b"][i],
                       cfg["departures"]["layer_norm_eps"]["run"])
        u = F.gelu(lin(h, p["layers/mlp/w1"][i]) + p["layers/mlp/b1"][i],
                   approximate="tanh")
        x = x + lin(u, p["layers/mlp/w2"][i]) + p["layers/mlp/b2"][i]
    pooled = rms_norm(x, p["final_norm"]).mean(dim=1)
    logits = lin(pooled, p["head"])
    keep = torch.arange(logits.shape[-1], device=logits.device) \
        < cfg["num_labels"]
    logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def loss_and_grads(cfg: dict, params: dict, patches, labels, quant=exact):
    """(loss, {name: gradient}) of one rank's batch at ``params``."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    out = loss(cfg, leaves, patches, labels, quant)
    gs = torch.autograd.grad(out, list(leaves.values()))
    return out.detach(), dict(zip(leaves, gs))
