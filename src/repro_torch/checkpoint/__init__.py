"""Checkpoints of the port, on the JAX package's on-disk layout
(``ckpt.py``)."""
from .ckpt import AsyncCheckpointer, latest_step, restore, save

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
