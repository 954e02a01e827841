"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

These define the semantics the kernels must match bit for bit; each lives
beside its kernel wrapper and is re-exported here under the reference's
oracle name.
"""
from __future__ import annotations

from .chunk_combine import chunk_combine_plain
from .chunk_combine import chunk_combine_plain as chunk_combine_ref
from .fused_slice import fused_primitive_plain as fused_primitive_ref

__all__ = ["chunk_combine_plain", "chunk_combine_ref", "fused_primitive_ref"]
