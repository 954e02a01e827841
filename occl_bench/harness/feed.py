"""Weights and inputs drawn from ``--seed`` on the run's device.

Every draw takes its own generator, seeded from the run's seed and the
draw's name (and step), so the same seed gives the same weights and inputs
whatever else the run does.  Weights are drawn in one call per leaf (ViT:
one call for all leaves) in float32, the dtype they are kept in.
"""
from __future__ import annotations

import hashlib

import torch

from ..reference import moe as ref_moe
from ..reference import vit as ref_vit


def subseed(seed: int, *names) -> int:
    """A 63-bit seed for the draw ``names`` of run ``seed``."""
    key = ":".join(str(n) for n in (int(seed),) + names).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        subseed(seed, *names))


def vit_params(cfg: dict, seed: int, device) -> dict:
    """Flat ViT parameters: normals of std ``initializer_range``, LayerNorm
    weights about 1, every leaf random (so every leaf has a gradient)."""
    shapes = ref_vit.param_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, "vit"),
                       device=device) * cfg["initializer_range"]
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = flat[off:off + n].view(shape).clone()
        if name.endswith("norm_w"):
            leaf += 1.0
        out[name] = leaf
        off += n
    return out


class VitFeed:
    """One global batch per step (normal patches, uniform labels), dealt
    to the ranks in contiguous shards."""

    def __init__(self, cfg: dict, seed: int, device):
        dep = cfg["deployment"]
        self.cfg, self.seed, self.device = cfg, seed, device
        self.ranks, self.batch = dep["dp_ranks"], dep["global_batch"]
        self._step, self._global = None, None

    def global_batch(self, step: int) -> dict:
        if self._step != step:
            g = generator(self.device, self.seed, "batch", step)
            c = self.cfg
            patches = torch.randn(
                (self.batch, c["num_patches"], c["hidden_size"]),
                generator=g, device=self.device)
            labels = torch.randint(0, c["num_labels"], (self.batch,),
                                   generator=g, device=self.device,
                                   dtype=torch.int32)
            self._step, self._global = step, (patches, labels)
        return self._global

    def batch_for(self, step: int, rank: int) -> dict:
        patches, labels = self.global_batch(step)
        n = self.batch // self.ranks
        sl = slice(rank * n, (rank + 1) * n)
        return {"patches": patches[sl], "labels": labels[sl]}


def moe_params(cfg: dict, seed: int, device) -> dict:
    """The MoE layer's float32 leaves: std 0.02, the two down projections
    0.02 / sqrt(2 x the published depth)."""
    depth = cfg["published"].get("num_hidden_layers",
                                 cfg["num_hidden_layers"])
    down = 0.02 / (2 * depth) ** 0.5
    out = {}
    for name, shape in ref_moe.param_shapes(cfg).items():
        std = down if name in ("wd", "shared_wd") else 0.02
        out[name] = torch.randn(shape, generator=generator(device, seed,
                                                           "moe", name),
                                device=device) * std
    return out


def moe_tokens(cfg: dict, seed: int, step, device) -> list:
    """R [T, D] token matrices of one step: normals plus
    ``token_shared_direction`` times one shared direction, so the router's
    load is uneven and capacity drops real assignments.  Copied from
    ``chip_smoke.py:1637-1645`` (``moe_tokens``)."""
    dep = cfg["deployment"]
    g = generator(device, seed, "tokens", step)
    x = torch.randn((dep["ep_ranks"], dep["tokens_per_rank"],
                     cfg["hidden_size"]), generator=g, device=device)
    shared = torch.randn((cfg["hidden_size"],), generator=g, device=device)
    return list(x + dep["token_shared_direction"] * shared)
