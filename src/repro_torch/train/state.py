"""Train state: parameters, AdamW moments and the step counter.

PyTorch port of ``repro.train.state`` (``TrainState``, ``init_state``).
The partition specs and shardings wait for the sharding port (ROADMAP.md,
"Modules to port", item 6).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..core.state import resolve_device
from ..models import build_model
from ..optim.adamw import init_moments


class TrainState(NamedTuple):
    params: Any
    m: Any
    v: Any
    step: torch.Tensor     # [] int32


def init_state(cfg: ArchConfig, seed: int = 0, device=None) -> TrainState:
    """Fresh state on ``device`` (``None``: ``cuda``, raising without a
    card; ``"meta"``: shapes and dtypes only)."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    params = build_model(cfg).init(seed, dev)
    m, v = init_moments(params, cfg.moment_dtype)
    return TrainState(params, m, v,
                      torch.zeros((), dtype=torch.int32, device=dev))
