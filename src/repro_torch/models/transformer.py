"""The model zoo's training and serving paths: the dense, moe, ssm,
hybrid, encdec, vlm and ViT families.

PyTorch port of ``repro.models.transformer``: one functional ``Model`` per
architecture,

    init(seed, device) -> params           (nested dict, layers stacked [L])
    loss_fn(params, batch) -> scalar       (the train step's payload)
    prefill(params, batch, pad_to) -> (last logits [B, 1, V], cache)
    decode_step(params, cache, tokens) -> (logits [B, V], cache)

Parameters are the reference's nested dicts with the per-layer leaves
stacked on a leading [L] axis, so :func:`repro_torch.tree.tree_leaves`
gives the reference's leaf order and shapes (which decides the gradient
buckets of ``train/occl_sync.py``).  The layer loop is a Python loop over
the stack (the reference's ``lax.scan``); ``cfg.remat`` other than
``"none"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``): ``"full"`` recomputes all of it, ``"dots"``
saves the products without batch dimensions (``aten.mm`` / ``aten.addmm``,
the reference's ``dots_with_no_batch_dims_saveable``) and recomputes the
rest, batched products such as attention's included.  ``loss_fn`` casts
every parameter to ``cfg.compute_dtype`` first, as the reference does.

The families' blocks:

* moe: :mod:`repro_torch.models.moe` (each layer adds its load-balance
  loss to the trunk's aux term, weighted 0.01 in the loss);
* ssm (Mamba2, attention-free): :mod:`repro_torch.models.ssm`;
* hybrid (Zamba2): the ssm trunk plus ONE weight-shared block (``shared``:
  ``proj`` [2D, D], causal attention, SwiGLU) applied after every
  ``shared_attn_period``-th layer to ``concat(h, x0) @ proj``, ``x0`` the
  embedding; a Python branch on the static layer index where the
  reference takes ``lax.cond``;
* encdec (SeamlessM4T): a bidirectional, rotary encoder over
  ``batch["frames"]``, normalised by ``enc_norm``, that every decoder layer
  cross-attends (``cross``: only the query side normalised, the encoder
  memory through ``wk`` / ``wv`` as it is, no rope);
* vlm (PaliGemma): ``batch["patches"] @ vis_proj`` prepended to the
  tokens, prefix-LM attention over the image, GeGLU MLPs, the image
  positions stripped before the loss.

Serving: the cache is the reference's dict.  Dense, moe, encdec and vlm:
``k`` / ``v`` stacked [L, B, Smax, KV, dh] (zero-padded to ``pad_to``) and
``pos``, an int32 0-d tensor.  ``decode_step`` writes each layer's new
k / v into the cache IN PLACE at ``min(pos, Smax - 1)`` (the reference's
``dynamic_update_slice`` position, read on the device, never on the host)
and so consumes the cache it is given.  vlm: the cache covers the image
and the prompt, and ``pos`` starts after both; with ``pad_to`` below that
no padding happens and every decode step overwrites the last slot, as in
the reference.  encdec: the cache also carries ``enc_out``, and every
decode step recomputes the cross-attention K / V from it, as the
reference does.  ssm: ``state`` [L, B, H, N, P] float32, ``conv_x`` /
``conv_B`` / ``conv_C`` [L, B, d_conv - 1, C] (the trailing conv inputs)
and ``pos``; ``pad_to`` is ignored, the prompt length must be a multiple
of ``min(ssm_chunk, S)``, and ``decode_step`` writes the new states into
the cache in place too.  hybrid: the ssm cache plus ``shared_k`` /
``shared_v`` [n_layers // shared_attn_period, B, Smax, KV, dh], one per
application of the shared block, zero-padded to ``pad_to`` and written in
place as ``k`` / ``v`` are.  The vit family has no serving path
(``ValueError``, as the reference fails on its missing ``embed``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..tree import tree_map
from . import attention as A
from . import moe as M
from . import ssm as SSM
from .layers import (cross_entropy, geglu, gelu_mlp, layer_norm, ninit,
                     rms_norm, rope, swiglu)

VOCAB_PAD = 256   # Megatron-style: pad the vocab to a multiple of 256.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "vit")
SSM_CACHE = ("state", "conv_x", "conv_B", "conv_C")   # [L, ...] each


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


def _qkv(cfg, p, x, kv_x=None, *, rope_on=True):
    """q from ``x``, k / v from ``kv_x`` (default ``x``; cross-attention
    passes the encoder memory)."""
    B, Sq = x.shape[:2]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kv_x = x if kv_x is None else kv_x
    Skv = kv_x.shape[1]
    q = (x @ p["wq"]).reshape(B, Sq, H, dh)
    k = (kv_x @ p["wk"]).reshape(B, Skv, KV, dh)
    v = (kv_x @ p["wv"]).reshape(B, Skv, KV, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_on:
        pos = lambda n: torch.broadcast_to(
            torch.arange(n, device=x.device), (B, n))
        q = rope(q, pos(Sq), cfg.rope_theta)
        k = rope(k, pos(Skv), cfg.rope_theta)
    return q, k, v


def attn_train(cfg, p, x, *, mode="causal", prefix_len=0, kv_x=None,
               rope_on=True):
    """Attention block; with ``kv_x`` (the encoder memory, already
    normalised) a cross-attention that normalises only the query side."""
    h = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, h, kv_x, rope_on=rope_on)
    y = A.full_or_blockwise(q, k, v, mode=mode, window=cfg.swa_window,
                            prefix_len=prefix_len)
    B, Sq = x.shape[:2]
    return x + y.reshape(B, Sq, -1) @ p["wo"]


def attn_prefill(cfg, p, x, *, mode="causal", prefix_len=0):
    """Like :func:`attn_train`, also returning (k, v) for the cache."""
    h = rms_norm(x, p["norm"])
    q, k, v = _qkv(cfg, p, h)
    y = A.full_or_blockwise(q, k, v, mode=mode, window=cfg.swa_window,
                            prefix_len=prefix_len)
    B, Sq = x.shape[:2]
    return x + y.reshape(B, Sq, -1) @ p["wo"], (k, v)


def attn_decode(cfg, p, x, kc, vc, pos):
    """x: [B, 1, D]; kc / vc: [B, Smax, KV, dh], written IN PLACE at
    ``min(pos, Smax - 1)`` (past the end the last slot is overwritten and
    ``kv_len > Smax`` masks nothing, as in the reference); pos: 0-d int
    tensor."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["norm"])
    q = (h @ p["wq"]).reshape(B, 1, H, dh)
    k = (h @ p["wk"]).reshape(B, 1, KV, dh)
    v = (h @ p["wv"]).reshape(B, 1, KV, dh)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    ppos = torch.broadcast_to(pos, (B, 1))
    q = rope(q, ppos, cfg.rope_theta)
    k = rope(k, ppos, cfg.rope_theta)
    wpos = torch.clamp(pos, max=kc.shape[1] - 1).long().reshape(1)
    kc.index_copy_(1, wpos, k)
    vc.index_copy_(1, wpos, v)
    y = A.decode_attention(q, kc, vc, pos, window=cfg.swa_window)
    return x + y.reshape(B, 1, -1) @ p["wo"]


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
    fn = geglu if kind == "geglu" else swiglu
    return x + fn(h, p["wg"], p["wu"], p["wd"])


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


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: keep the
    outputs of 2-D products (a ``[..., D] @ [D, F]`` folds its leading
    dimensions into one ``mm``), recompute every other op."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)   # full


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
            raise ValueError(fam)
        D, V = cfg.d_model, padded_vocab(cfg.vocab)
        w = lambda path, shape: ninit(seed, path, shape, 0.02, dt, device)
        zeros = lambda: torch.zeros((D,), dtype=dt, device=device)
        attn = lambda path: init_attn(seed, path, cfg, dt, device)
        mlp = lambda path, kind="swiglu": init_mlp(seed, path, cfg, dt,
                                                   device, kind=kind)
        p: dict[str, Any] = {}
        if fam == "vit":
            p["pos_embed"] = w("pos", (cfg.vis_tokens, D))
            p["patch_proj"] = w("patch_proj", (D, D))
            p["layers"] = _stack([{"attn": attn(f"l{i}/attn"),
                                   "mlp": mlp(f"l{i}/mlp", "gelu")}
                                  for i in range(cfg.n_layers)])
            p["final_norm"] = zeros()
            p["head"] = w("head", (D, V))
            return p
        p["embed"] = w("embed", (V, D))
        if fam in ("dense", "vlm"):
            block = lambda i: {"attn": attn(f"l{i}/attn"),
                               "mlp": mlp(f"l{i}/mlp")}
        elif fam == "moe":
            block = lambda i: {"attn": attn(f"l{i}/attn"),
                               "moe": M.init_moe_block(seed, f"l{i}/moe",
                                                       cfg, dt, device)}
        elif fam == "encdec":
            block = lambda i: {"attn": attn(f"d{i}/attn"),
                               "cross": attn(f"d{i}/cross"),
                               "mlp": mlp(f"d{i}/mlp")}
        else:   # ssm, hybrid
            block = lambda i: SSM.init_ssm_block(seed, f"l{i}", cfg, dt,
                                                 device)
        p["layers"] = _stack([block(i) for i in range(cfg.n_layers)])
        if fam == "hybrid":
            p["shared"] = {"proj": w("shared/proj", (2 * D, D)),
                           "attn": attn("shared/attn"),
                           "mlp": mlp("shared/mlp")}
        elif fam == "encdec":
            p["enc_layers"] = _stack([{"attn": attn(f"e{i}/attn"),
                                       "mlp": mlp(f"e{i}/mlp")}
                                      for i in range(cfg.enc_layers)])
            p["enc_norm"] = zeros()
        elif fam == "vlm":
            p["vis_proj"] = w("vis_proj", (D, D))
        p["final_norm"] = zeros()
        p["lm_head"] = w("lm_head", (D, V))
        return p

    # ------------------------------------------------------------------
    def _mlp_kind(self) -> str:
        return "geglu" if self.cfg.family == "vlm" else "swiglu"

    def _shared(self, sp, h, x0, kv=None, pos=None):
        """The hybrid's shared block on ``concat(h, x0) @ proj``, added to
        ``h``.  ``kv``: this application's (k, v) cache, for a decode step
        at ``pos``; without it the block runs causally over the sequence
        and also returns its (k, v)."""
        z = torch.cat([h, x0], dim=-1) @ sp["proj"]
        if kv is None:
            z, kv = attn_prefill(self.cfg, sp["attn"], z)
        else:
            z = attn_decode(self.cfg, sp["attn"], z, *kv, pos)
        return h + mlp_apply(sp["mlp"], z, "swiglu"), kv

    def _encode(self, params, frames, policy: str):
        """The encdec encoder (bidirectional, rotary) -> its normalised
        output, the decoder's cross-attention memory."""
        cfg = self.cfg

        def body(h, lp):
            h = attn_train(cfg, lp["attn"], h, mode="bidir")
            return mlp_apply(lp["mlp"], h, "swiglu")

        body = _remat(body, policy)
        for lp in _layers(params["enc_layers"], cfg.enc_layers):
            frames = body(frames, lp)
        return rms_norm(frames, params["enc_norm"])

    def _trunk_train(self, params, x, *, mode="causal", prefix_len=0,
                     enc_out=None):
        """The decoder stack: (x, summed aux load-balance loss)."""
        cfg = self.cfg
        fam = cfg.family
        kind = self._mlp_kind()
        if fam in ("dense", "vlm"):
            def body(h, lp, i):
                h = attn_train(cfg, lp["attn"], h, mode=mode,
                               prefix_len=prefix_len)
                return mlp_apply(lp["mlp"], h, kind), None
        elif fam == "moe":
            def body(h, lp, i):
                h = attn_train(cfg, lp["attn"], h, mode=mode)
                y, a = M.moe_forward(cfg, lp["moe"], h)
                return h + y, a
        elif fam == "encdec":
            def body(h, lp, i):
                h = attn_train(cfg, lp["attn"], h)
                h = attn_train(cfg, lp["cross"], h, mode="bidir",
                               kv_x=enc_out, rope_on=False)
                return mlp_apply(lp["mlp"], h, kind), None
        else:   # ssm, hybrid: the layer index is static, x the embedding
            def body(h, lp, i):
                h = SSM.ssd_forward(cfg, lp, h)[0]
                if fam == "hybrid" and (i + 1) % cfg.shared_attn_period == 0:
                    h = self._shared(params["shared"], h, x)[0]
                return h, None

        body = _remat(body, cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = x
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            h, a = body(h, lp, i)
            if a is not None:
                aux = aux + a
        return h, aux

    # ------------------------------------------------------------------
    def _embed(self, params, batch, enc: str):
        """Token embeddings, with the vlm's image prefix: (x, mode,
        prefix_len, encdec memory or None).  ``enc``: the encoder's remat
        policy."""
        cfg = self.cfg
        cdt = getattr(torch, cfg.compute_dtype)
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self._encode(params, batch["frames"].to(cdt), enc)
        x = params["embed"][batch["tokens"].long()]
        if cfg.family == "vlm":
            vis = batch["patches"].to(cdt) @ params["vis_proj"]
            return torch.cat([vis, x], dim=1), "prefix", cfg.vis_tokens, None
        return x, "causal", 0, enc_out

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

        x, mode, prefix_len, enc_out = self._embed(params, batch, cfg.remat)
        x, aux = self._trunk_train(params, x, mode=mode,
                                   prefix_len=prefix_len, enc_out=enc_out)
        x = rms_norm(x, params["final_norm"])
        if fam == "vlm":    # strip the image positions from the loss
            x = x[:, cfg.vis_tokens:]
        logits = mask_vocab_logits((x @ params["lm_head"]).float(),
                                   cfg.vocab)
        return cross_entropy(logits, batch["targets"]) + 0.01 * aux

    # ------------------------------------------------------------------
    # serving: prefill + decode
    # ------------------------------------------------------------------
    def _serving_family(self) -> None:
        if self.cfg.family == "vit":
            raise ValueError(self.cfg.family)

    def _block_ffn(self, lp, h):
        if self.cfg.family == "moe":
            y, _ = M.moe_forward(self.cfg, lp["moe"], h)
            return h + y
        return mlp_apply(lp["mlp"], h, self._mlp_kind())

    def _last_logits(self, params, x):
        x = rms_norm(x, params["final_norm"])
        return mask_vocab_logits((x @ params["lm_head"]).float(),
                                 self.cfg.vocab)

    def prefill(self, params, batch, pad_to=None):
        """Pass over ``batch["tokens"]`` [B, S] (and the family's
        ``patches`` / ``frames``) -> (logits of the last position
        [B, 1, V], cache).  ``pad_to``: the cache's capacity (prompt, image
        and expected decode steps); without it the first decode step has
        no free slot and overwrites the last cached position."""
        self._serving_family()
        cfg = self.cfg
        fam = cfg.family
        cdt = getattr(torch, cfg.compute_dtype)
        params = tree_map(lambda a: a.to(cdt), params)
        x, mode, prefix_len, enc_out = self._embed(params, batch, "none")
        B, S = x.shape[:2]
        Smax = max(S, pad_to or 0)
        kv_shape = lambda n: (n, B, Smax, cfg.n_kv_heads, cfg.d_head)
        if fam in ("ssm", "hybrid"):
            x0, outs, kvs = x, [], []
            for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
                x, (st, cv) = SSM.ssd_forward(cfg, lp, x)
                outs.append((st, *cv))
                if fam == "hybrid" and (i + 1) % cfg.shared_attn_period == 0:
                    x, kv = self._shared(params["shared"], x, x0)
                    kvs.append(kv)
            cache = {k: torch.stack(v) for k, v in zip(SSM_CACHE,
                                                       zip(*outs))}
            if kvs:
                for name, part in (("shared_k", 0), ("shared_v", 1)):
                    buf = torch.zeros(kv_shape(len(kvs)), dtype=cdt,
                                      device=x.device)
                    buf[:, :, :S] = torch.stack([kv[part] for kv in kvs])
                    cache[name] = buf
        else:
            kc = torch.zeros(kv_shape(cfg.n_layers), dtype=cdt,
                             device=x.device)
            vc = torch.zeros_like(kc)
            for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
                x, (k, v) = attn_prefill(cfg, lp["attn"], x, mode=mode,
                                         prefix_len=prefix_len)
                kc[i, :, :S] = k
                vc[i, :, :S] = v
                if fam == "encdec":
                    x = attn_train(cfg, lp["cross"], x, mode="bidir",
                                   kv_x=enc_out, rope_on=False)
                x = self._block_ffn(lp, x)
            cache = {"k": kc, "v": vc}
            if fam == "encdec":
                cache["enc_out"] = enc_out
        cache["pos"] = torch.tensor(S, dtype=torch.int32, device=x.device)
        return self._last_logits(params, x[:, -1:]), cache

    def decode_step(self, params, cache, tokens):
        """tokens: [B] int32 -> (logits [B, V], cache with ``pos + 1``).
        The input cache is CONSUMED: its ``k`` / ``v`` (ssm and hybrid:
        ``state``, the conv states and ``shared_k`` / ``shared_v``) are
        written in place and returned in the new cache."""
        self._serving_family()
        cfg = self.cfg
        fam = cfg.family
        cdt = getattr(torch, cfg.compute_dtype)
        params = tree_map(lambda a: a.to(cdt), params)
        pos = cache["pos"]
        x = params["embed"][tokens.long()[:, None]]
        if fam in ("ssm", "hybrid"):
            x0, inv = x, 0
            for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
                old = [cache[k][i] for k in SSM_CACHE]
                x, (st, cv) = SSM.ssd_decode_step(cfg, lp, x,
                                                  (old[0], tuple(old[1:])))
                for dst, src in zip(old, (st, *cv)):
                    dst.copy_(src)
                if fam == "hybrid" and (i + 1) % cfg.shared_attn_period == 0:
                    kv = (cache["shared_k"][inv], cache["shared_v"][inv])
                    x, _ = self._shared(params["shared"], x, x0, kv, pos)
                    inv += 1
        else:
            for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
                x = attn_decode(cfg, lp["attn"], x, cache["k"][i],
                                cache["v"][i], pos)
                if fam == "encdec":
                    x = attn_train(cfg, lp["cross"], x, mode="bidir",
                                   kv_x=cache["enc_out"], rope_on=False)
                x = self._block_ffn(lp, x)
        return (self._last_logits(params, x[:, 0]),
                dict(cache, pos=pos + 1))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
