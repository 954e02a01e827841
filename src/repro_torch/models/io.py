"""Input specs and synthetic batches for every (arch x shape-cell).

PyTorch port of ``repro.models.io``.  ``input_specs`` returns
:class:`TensorSpec` stand-ins (shape and dtype, no allocation) — the dry
run plans from these.  ``make_concrete`` materializes random tensors of the
same specs (the reference's numpy draws, in its leaf order).

Modality frontends are stubs, as in the reference: ``[vit]`` and ``[vlm]``
get patch embeddings (vlm then ``S - vis_tokens`` text tokens),
``[encdec]`` frame embeddings.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeCell
from ..core.state import resolve_device
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``;
    not a tuple, so the port's tree functions take it as a leaf)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), dtype)


def train_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vit":
        return {"patches": _spec((B, cfg.vis_tokens, cfg.d_model), cdt),
                "labels": _spec((B,), torch.int32)}
    out = {}
    text = S
    if cfg.family == "vlm":
        text = S - cfg.vis_tokens
        out["patches"] = _spec((B, cfg.vis_tokens, cfg.d_model), cdt)
    if cfg.family == "encdec":
        out["frames"] = _spec((B, cfg.enc_frames, cfg.d_model), cdt)
    out["tokens"] = _spec((B, text), torch.int32)
    out["targets"] = _spec((B, text), torch.int32)
    return out


def prefill_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    specs = train_specs(cfg, cell)
    specs.pop("targets", None)
    specs.pop("labels", None)
    return specs


def cache_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    """Cache specs of a decode cell (cache length = seq_len)."""
    B, Smax = cell.global_batch, cell.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    L = cfg.n_layers
    fam = cfg.family
    out = {"pos": _spec((), torch.int32)}
    if fam in ("dense", "vlm", "moe", "encdec"):
        kv, dh = cfg.n_kv_heads, cfg.d_head
        out["k"] = _spec((L, B, Smax, kv, dh), cdt)
        out["v"] = _spec((L, B, Smax, kv, dh), cdt)
        if fam == "encdec":
            out["enc_out"] = _spec((B, cfg.enc_frames, cfg.d_model), cdt)
    elif fam in ("ssm", "hybrid"):
        H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        GN = cfg.ssm_groups * N
        K1 = cfg.ssm_dconv - 1
        out["state"] = _spec((L, B, H, N, P), torch.float32)
        out["conv_x"] = _spec((L, B, K1, cfg.d_inner), cdt)
        out["conv_B"] = _spec((L, B, K1, GN), cdt)
        out["conv_C"] = _spec((L, B, K1, GN), cdt)
        if fam == "hybrid":
            n_inv = cfg.n_layers // cfg.shared_attn_period
            kv, dh = cfg.n_kv_heads, cfg.d_head
            out["shared_k"] = _spec((n_inv, B, Smax, kv, dh), cdt)
            out["shared_v"] = _spec((n_inv, B, Smax, kv, dh), cdt)
    else:
        raise ValueError(fam)
    return out


def decode_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    return {"cache": cache_specs(cfg, cell),
            "tokens": _spec((cell.global_batch,), torch.int32)}


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    if cell.kind == "train":
        return train_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_specs(cfg, cell)
    return decode_specs(cfg, cell)


def make_concrete(specs, seed: int = 0, vocab: int = 1 << 30,
                  device=None):
    """Random tensors on ``device`` (``None``: ``cuda``, raising without a
    card) matching a spec tree, drawn in the reference's leaf order from
    one ``numpy`` stream: integers uniform below ``min(vocab, 2^15)``,
    floats normal times 0.02."""
    rng = np.random.RandomState(seed)
    device = resolve_device(device)

    def gen(s: TensorSpec) -> torch.Tensor:
        if not s.dtype.is_floating_point:
            hi = min(vocab, 1 << 15)
            a = rng.randint(0, max(hi, 2), size=s.shape)
        else:
            a = rng.randn(*s.shape) * 0.02
        return torch.from_numpy(np.asarray(a)).to(device=device,
                                                  dtype=s.dtype)

    return tree_map(gen, specs)
