"""Shared neural-net building blocks (plain PyTorch on tensors).

PyTorch port of ``repro.models.layers``.  The formulas are the reference's,
dtype for dtype: norms and rotary embeddings compute in float32 and cast
back; ``rms_norm`` scales by ``1 + w``; ``rope`` rotates halves (not
interleaved pairs); ``geglu`` and ``gelu_mlp`` use the tanh approximation.  The
reference's per-parameter RNG (``key_for`` / ``ninit``) becomes
:func:`ninit` with an explicit :class:`torch.Generator` per parameter path,
seeded from the CRC of the model seed and the path, so a parameter's values
do not depend on the order of initialisation.  The two RNGs differ: parity
tests carry the reference's parameters across (``models/convert.py``).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F


def ninit(seed: int, path: str, shape, scale: float, dtype,
          device) -> torch.Tensor:
    """Normal(0, scale) init of the parameter at ``path`` from its own CPU
    generator, seeded with the CRC of the model seed and the path; drawn on
    the CPU and moved, so the values do not depend on the device.  On the
    meta device: shape and dtype only."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    g = torch.Generator(device="cpu")
    g.manual_seed(zlib.crc32(f"{int(seed)}:{path}".encode()))
    x = torch.randn(shape, generator=g) * scale
    return x.to(dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, dh]; positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ).to(x.device)
    ang = positions[..., :, None].float() * freqs      # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                 # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def geglu(x, wg, wu, wd):
    return (F.gelu(x @ wg, approximate="tanh") * (x @ wu)) @ wd


def gelu_mlp(x, w1, b1, w2, b2):
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token CE in f32.  logits [..., V]; targets [...] int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(
        lf, -1, targets.clamp(0, lf.shape[-1] - 1).long()[..., None])[..., 0]
    mask = (targets != ignore_id).float()
    return ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)
