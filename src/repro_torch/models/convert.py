"""Weights carried across from the JAX package.

The two packages draw parameters from different RNGs, so parity tests and
anyone moving a checkpoint hand the reference's parameters over as a
nested dict of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``).  The layout is the same on both sides — nested dicts, per-layer
leaves stacked on a leading [L] axis — so a leaf converts one to one.
bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16) keep their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device=None) -> dict:
    """The reference's params (numpy leaves) -> the port's, on ``device``
    (``None``: ``cuda``, raising without a card)."""
    from ..core.state import resolve_device

    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def train_state_from_numpy(params, m, v, step, device=None):
    """A reference ``TrainState``'s leaves (numpy) -> the port's
    :class:`~repro_torch.train.state.TrainState`."""
    from ..core.state import resolve_device
    from ..train.state import TrainState

    dev = resolve_device(device)
    return TrainState(params_from_numpy(params, dev),
                      params_from_numpy(m, dev), params_from_numpy(v, dev),
                      torch.as_tensor(np.array(step), dtype=torch.int32,
                                      device=dev))

