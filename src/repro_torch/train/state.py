"""Train state: parameters, AdamW moments and the step counter, and its
sharding specs.

PyTorch port of ``repro.train.state``: ``TrainState``, ``init_state``,
``abstract_state`` (the state on ``meta``: shapes and dtypes, no
allocation), ``state_pspecs`` (ZeRO-1 moments when ``cfg.zero1``) and
``state_shardings``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ArchConfig
from ..core.state import resolve_device
from ..models import build_model
from ..optim.adamw import init_moments, zero1_pspecs
from ..parallel.sharding import NamedSharding, P, axis_sizes, param_pspecs
from ..tree import tree_map


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


def abstract_state(cfg: ArchConfig) -> TrainState:
    """The state on ``meta`` (no allocation) — the dry run's input."""
    return init_state(cfg, device="meta")


def state_pspecs(cfg: ArchConfig, state: TrainState,
                 data_size: int = 16) -> TrainState:
    ps = param_pspecs(state.params)
    if cfg.zero1:
        mom = zero1_pspecs(ps, state.params, data_size)
    else:
        mom = ps
    return TrainState(params=ps, m=mom, v=mom, step=P())


def state_shardings(mesh, cfg: ArchConfig,
                    state: TrainState) -> TrainState:
    """``state_pspecs`` on ``mesh`` (a placement or a planning mesh), with
    the ZeRO-1 shard count taken from its "data" axis (1 without one)."""
    specs = state_pspecs(cfg, state, axis_sizes(mesh).get("data", 1))
    return tree_map(lambda s: NamedSharding(mesh, s), specs)
