"""Dispatch layer over the port's kernels, by tensor device.

``fused_primitive_batch`` is the scheduler's entry point: the whole
[R*L*B, SLICE] superstep burst in ONE call.  Tensors on the card launch the
hand-written CUDA kernel; tensors on the CPU take its plain PyTorch
version (the tests' path).  ``chunk_combine`` has no counterpart yet: its
TPU kernel is off the main path and still to be ported (ROADMAP.md).
"""
from __future__ import annotations

from . import ref
from .fused_slice import fused_primitive

# payload, local: [N, S]; flags: [N, 4] int32 (recv, reduce, reads_in, op)
# -> value [N, S].  The wrapper itself dispatches by tensor device.
fused_primitive_batch = fused_primitive
fused_primitive_ref = ref.fused_primitive_ref
