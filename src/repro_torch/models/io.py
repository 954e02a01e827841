"""Input specs of a training batch for an (arch x shape-cell).

PyTorch port of ``repro.models.io.train_specs``: :class:`TensorSpec`
stand-ins (shape and dtype, no allocation).  Modality frontends are stubs,
as in the reference: ``[vit]`` and ``[vlm]`` get patch embeddings (vlm
then ``S - vis_tokens`` text tokens), ``[encdec]`` frame embeddings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import ArchConfig, ShapeCell


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def train_specs(cfg: ArchConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vit":
        return {"patches": TensorSpec((B, cfg.vis_tokens, cfg.d_model), cdt),
                "labels": TensorSpec((B,), torch.int32)}
    out = {}
    text = S
    if cfg.family == "vlm":
        text = S - cfg.vis_tokens
        out["patches"] = TensorSpec((B, cfg.vis_tokens, cfg.d_model), cdt)
    if cfg.family == "encdec":
        out["frames"] = TensorSpec((B, cfg.enc_frames, cfg.d_model), cdt)
    out["tokens"] = TensorSpec((B, text), torch.int32)
    out["targets"] = TensorSpec((B, text), torch.int32)
    return out
