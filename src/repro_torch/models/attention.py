"""Attention: GQA/MQA/MHA masks, plain and blockwise (flash-style) paths,
and KV-cache decode.

PyTorch port of ``repro.models.attention``.  Shapes:
q [B, S, Hq, dh]; k/v [B, Skv, Hkv, dh]; Hq = Hkv * q_per_kv.  Scores and
softmax statistics are float32, masked positions add ``NEG_INF``, and the
stored probabilities take ``_p_dtype()`` before the PV product, which
accumulates in float32 — the reference's numerics.  These are plain tensor
math in the reference too (no TPU kernel), so plain PyTorch ops are the
port.  The knobs read the reference's environment variables
(``REPRO_BLOCKWISE_THRESHOLD``, ``REPRO_KV_BLOCK``, ``REPRO_ATTN_BF16``,
``REPRO_CAUSAL_REC``: the recursive-halving causal path's levels).
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
              prefix_len: int = 0, q_offset: int | torch.Tensor = 0,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain O(S^2)-memory attention.  ``kv_len``: optional valid KV length;
    positions >= kv_len are masked out.  ``q_offset`` and ``kv_len`` may be
    0-d device tensors (decode): nothing reads them on the host."""
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


def _blockwise_stats(q, k, v, *, mode: str, window: int, prefix_len: int,
                     q_offset: int = 0, k_offset: int = 0) -> tuple:
    """Flash-style streaming over KV blocks of ``min(_kv_block(), Skv)``
    with a running (max, sum, acc) per query, returned before the
    normalisation so that partial attentions merge; fully masked blocks
    still stream, as in the reference."""
    B, S, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    KB = min(_kv_block(), Skv)
    nb = Skv // KB
    assert Skv % KB == 0
    qf = q.float().reshape(B, S, Hkv, g, dh) / np.sqrt(dh)
    kb = k.float().reshape(B, nb, KB, Hkv, dh)
    vb = v.float().reshape(B, nb, KB, Hkv, dh)
    qpos = torch.arange(S, device=q.device) + q_offset
    m_run = torch.full((B, Hkv, g, S), NEG_INF, device=q.device)
    l_run = torch.zeros((B, Hkv, g, S), device=q.device)
    acc = torch.zeros((B, Hkv, g, S, dh), device=q.device)
    for j in range(nb):
        kpos = k_offset + j * KB + torch.arange(KB, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb[:, j])
        s = s + _mask(qpos, kpos, mode, window, prefix_len)[None, None, None]
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m_run - m_new)
        l_run = l_run * scale + p.sum(-1)
        acc = acc * scale[..., None] + _pv(p, vb[:, j],
                                           "bhgqk,bkhd->bhgqd")
        m_run = m_new
    return m_run, l_run, acc


def _merge_stats(a: tuple, b: tuple) -> tuple:
    """Merge two flash partials over disjoint KV ranges."""
    ma, la, xa = a
    mb, lb, xb = b
    m = torch.maximum(ma, mb)
    sa, sb = torch.exp(ma - m), torch.exp(mb - m)
    return m, la * sa + lb * sb, xa * sa[..., None] + xb * sb[..., None]


def _finish_stats(stats: tuple, dtype) -> torch.Tensor:
    _, l_run, acc = stats
    B, Hkv, g, S, dh = acc.shape
    out = acc / l_run.clamp(min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, S, Hkv * g, dh).to(dtype)


def blockwise_attention(q, k, v, *, mode: str = "causal", window: int = 0,
                        prefix_len: int = 0) -> torch.Tensor:
    """Flash-style streaming attention over KV blocks of ``_kv_block()``."""
    assert k.shape[1] % _kv_block() == 0, \
        "pad sequences to a multiple of the KV block"
    return _finish_stats(_blockwise_stats(q, k, v, mode=mode, window=window,
                                          prefix_len=prefix_len), q.dtype)


def causal_rec_stats(q, k, v, levels: int, q_offset: int = 0,
                     k_offset: int = 0) -> tuple:
    """Recursive-halving causal attention: causal(S) = [causal(top half)]
    and [full(bottom -> top) merged with causal(bottom half)], so each
    level skips the strictly upper quarter of the score matrix with static
    shapes; below two KV blocks (or at an odd length) it streams blockwise."""
    S = q.shape[1]
    if levels <= 0 or S < 2 * _kv_block() or S % 2:
        return _blockwise_stats(q, k, v, mode="causal", window=0,
                                prefix_len=0, q_offset=q_offset,
                                k_offset=k_offset)
    h = S // 2
    top = causal_rec_stats(q[:, :h], k[:, :h], v[:, :h], levels - 1,
                           q_offset, k_offset)
    bot_full = _blockwise_stats(q[:, h:], k[:, :h], v[:, :h], mode="bidir",
                                window=0, prefix_len=0,
                                q_offset=q_offset + h, k_offset=k_offset)
    bot_diag = causal_rec_stats(q[:, h:], k[:, h:], v[:, h:], levels - 1,
                                q_offset + h, k_offset + h)
    bot = _merge_stats(bot_full, bot_diag)
    return tuple(torch.cat([t, b], dim=3) for t, b in zip(top, bot))


def causal_rec_attention(q, k, v, levels: int = 2) -> torch.Tensor:
    return _finish_stats(causal_rec_stats(q, k, v, levels), q.dtype)


def full_or_blockwise(q, k, v, **kw) -> torch.Tensor:
    """Plain attention up to ``_blockwise_threshold()`` query positions,
    beyond it blockwise; with ``REPRO_CAUSAL_REC`` > 0 a causal,
    unwindowed self-attention (Sq == Skv) takes the recursive path."""
    if q.shape[1] > _blockwise_threshold():
        levels = int(os.environ.get("REPRO_CAUSAL_REC", "0"))
        if (levels > 0 and kw.get("mode", "causal") == "causal"
                and not kw.get("window") and q.shape[1] == k.shape[1]):
            return causal_rec_attention(q, k, v, levels)
        return blockwise_attention(q, k, v, **kw)
    return attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0
                     ) -> torch.Tensor:
    """Single-token decode against a cache [B, Smax, Hkv, dh]; ``pos`` (a
    0-d int tensor) = the number of valid positions before this token.

    With ``window > 0`` the reference computes the plain result and then
    replaces it with a second computation over the trailing window
    (``kv_len - window <= kpos < kv_len``): a plain float32 softmax and a
    float32 PV product without ``_p_dtype()`` rounding.  Only that second
    computation runs here; the value is the same."""
    kv_len = pos + 1
    if window <= 0:
        return attention(q, k_cache, v_cache, mode="bidir", window=0,
                         q_offset=pos, kv_len=kv_len)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    keep = (kpos >= kv_len - window) & (kpos < kv_len)
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    g = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_cache.float()) / np.sqrt(dh)
    s = s + torch.where(keep, 0.0, NEG_INF)[None, None, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.float())
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)
