"""Seeds of the draws a family makes on the run's device.

Every draw takes its own generator, seeded from the run's seed and the
draw's name (and step), so the same seed gives the same weights and inputs
whatever else the run does.  What a family draws with them is in its file
(``families/<family>.py``).
"""
from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, *names) -> int:
    """A 63-bit seed for the draw ``names`` of run ``seed``."""
    key = ":".join(str(n) for n in (int(seed),) + names).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        subseed(seed, *names))
