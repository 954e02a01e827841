"""Bulk chunk combine: hand-written CUDA kernel + wrapper.

Replaces the TPU kernel ``chunk_combine_pallas``
(``src/repro/kernels/chunk_combine.py``, body ``_kernel``): an elementwise
combine of two flat ``[T]`` buffers, loaded as f32, combined by a STATIC op
(0 sum, 1 max, 2 min, 3 prod; max/min propagate NaN) and rounded once to
the input dtype — ``recvReduceSend`` over a whole chunk, the bulk ring
reduce of a gradient bucket.

The CUDA source is ``src/repro_torch/csrc/chunk_combine.cu`` (sm_90a), built
by the shared ``nvcc`` + ``ctypes`` route of :mod:`._build`.  What bounds it
on the card: memory traffic, 3 * T * itemsize bytes (2 reads + 1 write).
Its design: a grid-stride loop over 16-byte vectors with a scalar head and
tail, since a heap slice need not be 16-byte aligned and T need not divide
anything.  The wrapper gives the output the same offset modulo 16 bytes as
``a`` (a view into a slightly larger allocation), so one ``head`` aligns all
three pointers whenever ``a`` and ``b`` agree modulo 16 bytes; otherwise the
kernel runs element by element.

No path of the runtime calls it: the reference package has no caller of
``ops.chunk_combine`` in its sources either.

Dispatch: :func:`chunk_combine` launches the kernel for CUDA tensors and
uses :func:`chunk_combine_plain` only for CPU tensors — there is no
fallback from the card.  ``chunk_combine.launches`` counts kernel launches
and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.occl_chunk_combine.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p]
    lib.occl_chunk_combine.restype = ctypes.c_int


LIBRARY = _build.Library("chunk_combine.cu", _bind)


def chunk_combine_plain(a: torch.Tensor, b: torch.Tensor, op: int = 0
                        ) -> torch.Tensor:
    """Plain PyTorch version: ``op(a, b)`` in f32, cast back
    (``src/repro/kernels/ref.py`` ``chunk_combine_ref``)."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    if op == 0:
        v = af + bf
    elif op == 1:
        v = torch.maximum(af, bf)
    elif op == 2:
        v = torch.minimum(af, bf)
    else:
        v = af * bf
    return v.to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor, op: int) -> None:
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"chunk_combine: unsupported dtype {a.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"chunk_combine: b dtype {b.dtype} != a dtype "
                        f"{a.dtype}")
    if a.dim() != 1 or b.shape != a.shape:
        raise ValueError(f"chunk_combine: a and b must be one flat [T] "
                         f"shape, got {tuple(a.shape)} / {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("chunk_combine: inputs must be contiguous")
    if a.device != b.device:
        raise ValueError("chunk_combine: inputs on different devices")
    if op not in (0, 1, 2, 3):
        raise ValueError(f"chunk_combine: op must be 0..3, got {op}")


def _aligned_like(a: torch.Tensor) -> torch.Tensor:
    """An empty [T] output whose address has ``a``'s offset modulo 16
    bytes (the caching allocator's blocks are 16-byte aligned)."""
    size = a.element_size()
    shift = (a.data_ptr() % 16) // size
    return torch.empty(a.numel() + 16 // size, dtype=a.dtype,
                       device=a.device)[shift:shift + a.numel()]


def chunk_combine(a: torch.Tensor, b: torch.Tensor, op: int = 0
                  ) -> torch.Tensor:
    """a, b: flat [T] (float32 / bfloat16 / float16, contiguous); ``op``
    static -> [T].  CUDA tensors launch the kernel on the current stream;
    CPU tensors take the plain version."""
    _check(a, b, op)
    if a.device.type == "cpu":
        return chunk_combine_plain(a, b, op)
    if a.device.type != "cuda":
        raise ValueError(f"chunk_combine: unsupported device {a.device}")
    t = a.numel()
    if t == 0:
        return torch.empty_like(a)
    out = _aligned_like(a)
    size = a.element_size()
    vec = 16 // size
    mis = a.data_ptr() % 16
    head = ((16 - mis) % 16) // size
    vec_ok = int(mis % size == 0 and b.data_ptr() % 16 == mis
                 and out.data_ptr() % 16 == mis and t >= head + vec)
    err = LIBRARY.load().occl_chunk_combine(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), t,
        _DTYPE_CODES[a.dtype], int(op), head if vec_ok else 0, vec_ok,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_combine kernel launch failed: CUDA error "
                           f"{err}")
    chunk_combine.launches += 1
    return out


chunk_combine.launches = 0
