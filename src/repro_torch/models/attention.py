"""Attention: GQA/MQA/MHA masks, plain and blockwise (flash-style) paths.

PyTorch port of the training half of ``repro.models.attention``.  Shapes:
q [B, S, Hq, dh]; k/v [B, Skv, Hkv, dh]; Hq = Hkv * q_per_kv.  Scores and
softmax statistics are float32, masked positions add ``NEG_INF``, and the
stored probabilities take ``_p_dtype()`` before the PV product, which
accumulates in float32 — the reference's numerics.  These are plain tensor
math in the reference too (no TPU kernel), so plain PyTorch ops are the
port.  The knobs read the reference's environment variables
(``REPRO_BLOCKWISE_THRESHOLD``, ``REPRO_KV_BLOCK``, ``REPRO_ATTN_BF16``).
The recursive-halving causal path (``REPRO_CAUSAL_REC``) and decode
attention are not ported yet (ROADMAP.md, "Modules to port", items 8 and
10).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _blockwise_threshold() -> int:
    """Sequence length above which attention streams KV blockwise."""
    return int(os.environ.get("REPRO_BLOCKWISE_THRESHOLD", "8192"))


def _kv_block() -> int:
    return int(os.environ.get("REPRO_KV_BLOCK", "1024"))


def _p_dtype() -> torch.dtype:
    """Dtype the attention probabilities are stored in before the PV
    product (float32 unless REPRO_ATTN_BF16=1)."""
    return torch.bfloat16 if os.environ.get("REPRO_ATTN_BF16") == "1" \
        else torch.float32


def _mask(qpos, kpos, mode: str, window: int, prefix_len: int
          ) -> torch.Tensor:
    """Additive float32 mask [..., Sq, Skv] from position vectors."""
    d = qpos[..., :, None] - kpos[..., None, :]
    if mode == "causal":
        ok = d >= 0
    elif mode == "bidir":
        ok = torch.ones_like(d, dtype=torch.bool)
    elif mode == "prefix":
        ok = (d >= 0) | (kpos[..., None, :] < prefix_len)
    else:
        raise ValueError(mode)
    if window > 0:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _pv(p: torch.Tensor, v: torch.Tensor, eq: str) -> torch.Tensor:
    """The PV product: operands rounded to ``_p_dtype()``, accumulated and
    returned in float32 (the reference's preferred_element_type)."""
    pdt = _p_dtype()
    return torch.einsum(eq, p.to(pdt).float(), v.to(pdt).float())


def attention(q, k, v, *, mode: str = "causal", window: int = 0,
              prefix_len: int = 0, q_offset: int = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain O(S^2)-memory attention.  ``kv_len``: optional valid KV length;
    positions >= kv_len are masked out."""
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / np.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    m = _mask(qpos, kpos, mode, window, prefix_len)
    if kv_len is not None:
        m = m + torch.where(kpos[None, :] < kv_len, 0.0, NEG_INF)
    p = torch.softmax(scores + m[None, None, None], dim=-1)
    out = _pv(p, v.float(), "bhgqk,bkhd->bqhgd")
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def blockwise_attention(q, k, v, *, mode: str = "causal", window: int = 0,
                        prefix_len: int = 0) -> torch.Tensor:
    """Flash-style streaming attention over KV blocks of ``_kv_block()``
    with a running (max, sum, acc) per query; fully masked blocks still
    stream, as in the reference."""
    B, S, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    KB = _kv_block()
    nb = Skv // KB
    assert Skv % KB == 0, "pad sequences to a multiple of the KV block"
    qf = q.float().reshape(B, S, Hkv, g, dh) / np.sqrt(dh)
    kb = k.float().reshape(B, nb, KB, Hkv, dh)
    vb = v.float().reshape(B, nb, KB, Hkv, dh)
    qpos = torch.arange(S, device=q.device)
    m_run = torch.full((B, Hkv, g, S), NEG_INF, device=q.device)
    l_run = torch.zeros((B, Hkv, g, S), device=q.device)
    acc = torch.zeros((B, Hkv, g, S, dh), device=q.device)
    for j in range(nb):
        kpos = j * KB + torch.arange(KB, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb[:, j])
        s = s + _mask(qpos, kpos, mode, window, prefix_len)[None, None, None]
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m_run - m_new)
        l_run = l_run * scale + p.sum(-1)
        acc = acc * scale[..., None] + _pv(p, vb[:, j],
                                           "bhgqk,bkhd->bhgqd")
        m_run = m_new
    out = acc / l_run.clamp(min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, S, Hq, dh).to(q.dtype)


def full_or_blockwise(q, k, v, **kw) -> torch.Tensor:
    if q.shape[1] > _blockwise_threshold():
        if int(os.environ.get("REPRO_CAUSAL_REC", "0")) > 0:
            raise NotImplementedError(
                "the recursive-halving causal attention is not ported yet "
                "(ROADMAP.md, 'Modules to port', item 8)")
        return blockwise_attention(q, k, v, **kw)
    return attention(q, k, v, **kw)
