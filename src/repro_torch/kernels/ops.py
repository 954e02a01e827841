"""Dispatch layer over the port's kernels, by tensor device.

``fused_primitive_batch`` is the scheduler's entry point: the whole
[R*L*B, SLICE] superstep burst in ONE call.  ``chunk_combine`` is the bulk
elementwise combine of two flat buffers.  Tensors on the card launch the
hand-written CUDA kernels; tensors on the CPU take their plain PyTorch
versions (the tests' path).  Each wrapper dispatches by tensor device
itself, with no fallback between the two.
"""
from __future__ import annotations

from . import ref
from .chunk_combine import chunk_combine
from .fused_slice import fused_primitive

# payload, local: [N, S]; flags: [N, 4] int32 (recv, reduce, reads_in, op)
# -> value [N, S].
fused_primitive_batch = fused_primitive
fused_primitive_ref = ref.fused_primitive_ref
# a, b: flat [T]; op static (0 sum, 1 max, 2 min, 3 prod) -> [T].
chunk_combine_ref = ref.chunk_combine_ref

__all__ = ["chunk_combine", "chunk_combine_ref", "fused_primitive_batch",
           "fused_primitive_ref"]
