"""Model FLOPs of one step, counted from shapes (no recomputation).

A matrix product of [m, k] by [k, n] counts 2*m*k*n.  A training step
counts three times its forward products (the backward pass takes two per
forward product); norms, softmax and element-wise work are left out.  Each
family counts its own step (``families/<family>.py`` ``step_flops``).
"""
from ..harness import manifest


def step_flops(cfg: dict) -> int:
    return manifest.family(cfg["family"]).step_flops(cfg)
