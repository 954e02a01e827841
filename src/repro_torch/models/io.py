"""Input specs of a training batch for an (arch x shape-cell).

PyTorch port of ``repro.models.io.train_specs`` for the dense, moe, ssm
and ViT families: :class:`TensorSpec` stand-ins (shape and dtype, no
allocation).  Modality frontends are stubs, as in the reference: ``[vit]``
gets patch embeddings.
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
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"train_specs for the {cfg.family} family is not ported yet "
            "(ROADMAP.md, 'Modules to port', item 4)")
    return {"tokens": TensorSpec((B, S), torch.int32),
            "targets": TensorSpec((B, S), torch.int32)}
