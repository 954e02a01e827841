"""The model zoo's training path for the dense, moe and ViT families.

PyTorch port of ``repro.models.transformer``: one functional ``Model`` per
architecture,

    init(seed, device) -> params           (nested dict, layers stacked [L])
    loss_fn(params, batch) -> scalar       (the train step's payload)

Parameters are the reference's nested dicts with the per-layer leaves
stacked on a leading [L] axis, so :func:`repro_torch.tree.tree_leaves`
gives the reference's leaf order and shapes (which decides the gradient
buckets of ``train/occl_sync.py``).  The layer loop is a Python loop over
the stack (the reference's ``lax.scan``); ``cfg.remat`` other than
``"none"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``; the reference's ``"dots"`` policy is not
distinguished from ``"full"``).  ``loss_fn`` casts every parameter to
``cfg.compute_dtype`` first, as the reference does.

The moe family's blocks are :mod:`repro_torch.models.moe` (each layer adds
its load-balance loss to the trunk's aux term, weighted 0.01 in the loss).

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md,
"Modules to port"): the ssm, hybrid, encdec and vlm families (item 8),
``prefill`` and ``decode_step`` (item 10, serving).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..tree import tree_map
from . import attention as A
from . import moe as M
from .layers import (cross_entropy, gelu_mlp, layer_norm, ninit, rms_norm,
                     rope, swiglu)

VOCAB_PAD = 256   # Megatron-style: pad the vocab to a multiple of 256.
FAMILIES = ("dense", "moe", "vit")


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def mask_vocab_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-1e30 on the padded tail so it never wins CE/argmax."""
    if logits.shape[-1] == vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return torch.where(keep, logits,
                       torch.full((), -1e30, dtype=logits.dtype,
                                  device=logits.device))


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, 'Modules to port', item "
        f"{item})")


# ======================================================================
# blocks
# ======================================================================
def init_attn(seed, path, cfg: ArchConfig, dtype, device):
    D = cfg.d_model
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    p = {
        "norm": z(D),
        "wq": ninit(seed, f"{path}/wq", (D, H * dh), 0.02, dtype, device),
        "wk": ninit(seed, f"{path}/wk", (D, KV * dh), 0.02, dtype, device),
        "wv": ninit(seed, f"{path}/wv", (D, KV * dh), 0.02, dtype, device),
        "wo": ninit(seed, f"{path}/wo", (H * dh, D),
                    0.02 / np.sqrt(2 * max(cfg.n_layers, 1)), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = z(dh)
        p["k_norm"] = z(dh)
    return p


def _qkv(cfg, p, x, *, rope_on=True):
    B, S = x.shape[:2]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, KV, dh)
    v = (x @ p["wv"]).reshape(B, S, KV, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_on:
        pos = torch.broadcast_to(torch.arange(S, device=x.device), (B, S))
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def attn_train(cfg, p, x):
    """Causal self-attention block (the dense family's)."""
    h = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, h)
    y = A.full_or_blockwise(q, k, v, mode="causal", window=cfg.swa_window)
    B, Sq = x.shape[:2]
    return x + y.reshape(B, Sq, -1) @ p["wo"]


def init_mlp(seed, path, cfg, dtype, device, kind="swiglu"):
    D, Fd = cfg.d_model, cfg.d_ff
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    if kind == "gelu":   # ViT-style with biases + LayerNorm
        return {
            "norm_w": torch.ones((D,), dtype=dtype, device=device),
            "norm_b": z(D),
            "w1": ninit(seed, f"{path}/w1", (D, Fd), 0.02, dtype, device),
            "b1": z(Fd),
            "w2": ninit(seed, f"{path}/w2", (Fd, D),
                        0.02 / np.sqrt(2 * cfg.n_layers), dtype, device),
            "b2": z(D),
        }
    return {
        "norm": z(D),
        "wg": ninit(seed, f"{path}/wg", (D, Fd), 0.02, dtype, device),
        "wu": ninit(seed, f"{path}/wu", (D, Fd), 0.02, dtype, device),
        "wd": ninit(seed, f"{path}/wd", (Fd, D),
                    0.02 / np.sqrt(2 * max(cfg.n_layers, 1)), dtype, device),
    }


def mlp_apply(p, x, kind="swiglu"):
    if kind == "gelu":
        h = layer_norm(x, p["norm_w"], p["norm_b"])
        return x + gelu_mlp(h, p["w1"], p["b1"], p["w2"], p["b2"])
    h = rms_norm(x, p["norm"])
    return x + swiglu(h, p["wg"], p["wu"], p["wd"])


def _stack(layers: list) -> dict:
    """Per-layer param dicts -> one dict of [L, ...] stacks."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def _layers(params: dict, n: int) -> list:
    """[L, ...] stacks -> per-layer dicts, with one ``unbind`` per leaf (so
    the backward pass stacks each leaf's gradient once)."""
    parts = {}

    def split(d, out):
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = {}
                split(v, out[k])
            else:
                out[k] = v.unbind(0)

    split(params, parts)

    def pick(d, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in d.items()}

    return [pick(parts, i) for i in range(n)]


def _remat(fn, policy: str):
    if policy == "none":
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


# ======================================================================
# the Model API
# ======================================================================
@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def init(self, seed: int = 0, device=None) -> dict:
        """Fresh parameters on ``device`` (``None``: ``cuda``, raising
        without a card; ``"meta"`` gives shapes and dtypes only)."""
        from ..core.state import resolve_device

        cfg = self.cfg
        device = torch.device("meta") if str(device) == "meta" \
            else resolve_device(device)
        dt = getattr(torch, cfg.param_dtype)
        fam = cfg.family
        if fam not in FAMILIES:
            raise _not_ported(f"the {fam} family", 8)
        V = padded_vocab(cfg.vocab)
        p: dict[str, Any] = {}
        if fam in ("dense", "moe"):
            p["embed"] = ninit(seed, "embed", (V, cfg.d_model), 0.02, dt,
                               device)
            if fam == "dense":
                block = lambda i: {"mlp": init_mlp(seed, f"l{i}/mlp", cfg,
                                                   dt, device)}
            else:
                block = lambda i: {"moe": M.init_moe_block(
                    seed, f"l{i}/moe", cfg, dt, device)}
            p["layers"] = _stack([{
                "attn": init_attn(seed, f"l{i}/attn", cfg, dt, device),
                **block(i)} for i in range(cfg.n_layers)])
            p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                          device=device)
            p["lm_head"] = ninit(seed, "lm_head", (cfg.d_model, V), 0.02,
                                 dt, device)
        else:   # vit
            p["pos_embed"] = ninit(seed, "pos", (cfg.vis_tokens, cfg.d_model),
                                   0.02, dt, device)
            p["patch_proj"] = ninit(seed, "patch_proj",
                                    (cfg.d_model, cfg.d_model), 0.02, dt,
                                    device)
            p["layers"] = _stack([{
                "attn": init_attn(seed, f"l{i}/attn", cfg, dt, device),
                "mlp": init_mlp(seed, f"l{i}/mlp", cfg, dt, device,
                                kind="gelu"),
            } for i in range(cfg.n_layers)])
            p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                          device=device)
            p["head"] = ninit(seed, "head", (cfg.d_model, V), 0.02, dt,
                              device)
        return p

    # ------------------------------------------------------------------
    def _trunk_train(self, params, x):
        """The decoder stack: (x, summed aux load-balance loss)."""
        cfg = self.cfg
        if cfg.family == "dense":
            def body(h, lp):
                h = attn_train(cfg, lp["attn"], h)
                return mlp_apply(lp["mlp"], h, "swiglu"), None
        elif cfg.family == "moe":
            def body(h, lp):
                h = attn_train(cfg, lp["attn"], h)
                y, a = M.moe_forward(cfg, lp["moe"], h)
                return h + y, a
        else:
            raise _not_ported(f"the {cfg.family} trunk", 8)

        body = _remat(body, cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in _layers(params["layers"], cfg.n_layers):
            x, a = body(x, lp)
            if a is not None:
                aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        params = tree_map(lambda a: a.to(cdt), params)
        fam = cfg.family

        if fam == "vit":
            x = batch["patches"].to(cdt) @ params["patch_proj"]
            x = x + params["pos_embed"][None]

            def body(h, lp):
                hh = rms_norm(h, lp["attn"]["norm"])
                q, k, v = _qkv(cfg, lp["attn"], hh, rope_on=False)
                y = A.attention(q, k, v, mode="bidir")
                h = h + y.reshape(h.shape[0], h.shape[1], -1) \
                    @ lp["attn"]["wo"]
                return mlp_apply(lp["mlp"], h, "gelu")

            body = _remat(body, cfg.remat)
            for lp in _layers(params["layers"], cfg.n_layers):
                x = body(x, lp)
            x = rms_norm(x, params["final_norm"]).mean(dim=1)
            logits = mask_vocab_logits((x @ params["head"]).float(),
                                       cfg.vocab)
            onehot = F.one_hot(batch["labels"].long(),
                               logits.shape[-1]).float()
            return -torch.mean(
                torch.sum(F.log_softmax(logits, dim=-1) * onehot, dim=-1))

        if fam not in ("dense", "moe"):
            raise _not_ported(f"the {fam} family", 8)
        x = params["embed"][batch["tokens"].long()]
        x, aux = self._trunk_train(params, x)
        x = rms_norm(x, params["final_norm"])
        logits = mask_vocab_logits((x @ params["lm_head"]).float(),
                                   cfg.vocab)
        return cross_entropy(logits, batch["targets"]) + 0.01 * aux

    # ------------------------------------------------------------------
    def prefill(self, params, batch, pad_to=None):
        raise _not_ported("prefill (serving)", 10)

    def decode_step(self, params, cache, tokens):
        raise _not_ported("decode_step (serving)", 10)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
