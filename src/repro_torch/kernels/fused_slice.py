"""Fused primitive slice application: hand-written CUDA kernel + wrapper.

Replaces the TPU kernel ``fused_primitive_pallas``
(``src/repro/kernels/fused_slice.py``, body ``_kernel``), which the
reference scheduler calls once per superstep over the whole burst.  For
each row n of ``payload``/``local`` ([N, S]) with ``flags[n]`` = (recv,
reduce, reads_in, op):

    value = op(payload, local)   in f32, rounded back   if reduce
          = payload                                     elif recv
          = local                                       elif reads_in
          = 0                                           otherwise

(op 0 sum, 1 max, 2 min, 3 prod, clipped to 0..3; max/min propagate NaN).

The CUDA source is ``src/repro_torch/csrc/fused_primitive.cu`` (sm_90a).
What bounds it on the card: memory traffic — 2 reads and 1 write of N*S
elements plus 16 bytes of flags per row.  At the scheduler's shapes (N =
R*L*B rows, S = slice_elems) the work is a few hundred KiB, so the launch
itself dominates: the kernel is launch-bound.  Its design (one block per
row, 16-byte loads and stores, flags read once per block) is the simple
correct one; fusing the scheduler's ``recv_val`` / ``in_val`` gathers
(``src/repro/core/scheduler.py:564-583``) into it is later work.

Build: the shared ``nvcc`` + ``ctypes`` route of :mod:`._build`
(``build/kernels/``, at first use); the launch check is the C function's
``cudaGetLastError()`` return, raised on by the wrapper.

Dispatch: :func:`fused_primitive` launches the kernel for CUDA tensors and
uses :func:`fused_primitive_plain` only for CPU tensors — there is no
fallback from the card.  ``fused_primitive.launches`` counts kernel
launches and nothing else: one per call that launches.  When the daemon
replays supersteps captured in a CUDA graph (``core/daemon.py``
``_ChunkRunner``), each replay adds the launches this wrapper counted
while the chunk was captured; the capture itself runs nothing and is not
counted.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.occl_fused_primitive.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.occl_fused_primitive.restype = ctypes.c_int


LIBRARY = _build.Library("fused_primitive.cu", _bind)


def fused_primitive_plain(payload: torch.Tensor, local: torch.Tensor,
                          flags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference's where-chain
    (``src/repro/kernels/ref.py:22-40``), computed in f32 and cast back."""
    recv = flags[:, 0:1] > 0
    reduce = flags[:, 1:2] > 0
    reads = flags[:, 2:3] > 0
    op = torch.clamp(flags[:, 3:4], 0, 3)
    pf = payload.to(torch.float32)
    lf = local.to(torch.float32)
    combined = torch.where(
        op == 0, pf + lf,
        torch.where(op == 1, torch.maximum(pf, lf),
                    torch.where(op == 2, torch.minimum(pf, lf), pf * lf)))
    val = torch.where(
        reduce, combined,
        torch.where(recv, pf, torch.where(reads, lf, torch.zeros_like(lf))))
    return val.to(payload.dtype)


def _check(payload, local, flags) -> None:
    if payload.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_primitive: unsupported dtype {payload.dtype}")
    if local.dtype != payload.dtype:
        raise TypeError(f"fused_primitive: local dtype {local.dtype} != "
                        f"payload dtype {payload.dtype}")
    if flags.dtype != torch.int32:
        raise TypeError(f"fused_primitive: flags must be int32, got "
                        f"{flags.dtype}")
    if payload.dim() != 2 or local.shape != payload.shape:
        raise ValueError(f"fused_primitive: payload/local must be one [N, S] "
                         f"shape, got {tuple(payload.shape)} / "
                         f"{tuple(local.shape)}")
    if tuple(flags.shape) != (payload.shape[0], 4):
        raise ValueError(f"fused_primitive: flags must be [N, 4], got "
                         f"{tuple(flags.shape)}")
    if not (payload.is_contiguous() and local.is_contiguous()
            and flags.is_contiguous()):
        raise ValueError("fused_primitive: inputs must be contiguous")
    if not (payload.device == local.device == flags.device):
        raise ValueError("fused_primitive: inputs on different devices")


def fused_primitive(payload: torch.Tensor, local: torch.Tensor,
                    flags: torch.Tensor) -> torch.Tensor:
    """payload, local: [N, S] (float32 / bfloat16 / float16, contiguous);
    flags: [N, 4] int32 -> value [N, S].  CUDA tensors launch the kernel on
    the current stream; CPU tensors take the plain version."""
    _check(payload, local, flags)
    if payload.device.type == "cpu":
        return fused_primitive_plain(payload, local, flags)
    if payload.device.type != "cuda":
        raise ValueError(f"fused_primitive: unsupported device "
                         f"{payload.device}")
    n, s = payload.shape
    out = torch.empty_like(payload)
    if n == 0 or s == 0:
        return out
    vec = 16 // payload.element_size()
    vec_ok = int(s % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in (payload, local, out)))
    err = LIBRARY.load().occl_fused_primitive(
        payload.data_ptr(), local.data_ptr(), flags.data_ptr(),
        out.data_ptr(), n, s, _DTYPE_CODES[payload.dtype], vec_ok,
        torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_primitive kernel launch failed: CUDA "
                           f"error {err}")
    fused_primitive.launches += 1
    return out


fused_primitive.launches = 0
