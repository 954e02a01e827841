"""Dispatch layer over the port's kernels, by tensor device.

``fused_burst`` is the scheduler's entry point: the whole slice burst of a
superstep (slot and window reads, the where-chain, the ``heap_out``
windows, the outbox) in ONE call.  ``fused_primitive_batch`` is the
one-to-one counterpart of the reference's ``[N, S]`` kernel contract, and
``chunk_combine`` the bulk elementwise combine of two flat buffers.  Tensors
on the card launch the hand-written CUDA kernels; tensors on the CPU take
their plain PyTorch versions (the tests' path).  Each wrapper dispatches by
tensor device itself, with no fallback between the two.
"""
from __future__ import annotations

from . import ref
from .chunk_combine import chunk_combine
from .fused_slice import (BurstLanes, BurstTables, fused_burst,
                          fused_burst_plain, fused_primitive)

# fused_burst(payload [R, C, K, SL], heap_in, heap_out [R, H] (heap_out
# written in place), B, BurstLanes [R, L], BurstTables) -> outbox payload
# [R, L, B, SL]; fused_burst_plain is its plain version.
# payload, local: [N, S]; flags: [N, 4] int32 (recv, reduce, reads_in, op)
# -> value [N, S].
fused_primitive_batch = fused_primitive
fused_primitive_ref = ref.fused_primitive_ref
# a, b: flat [T]; op static (0 sum, 1 max, 2 min, 3 prod) -> [T].
chunk_combine_ref = ref.chunk_combine_ref

__all__ = ["BurstLanes", "BurstTables", "chunk_combine", "chunk_combine_ref",
           "fused_burst", "fused_burst_plain", "fused_primitive_batch",
           "fused_primitive_ref"]
