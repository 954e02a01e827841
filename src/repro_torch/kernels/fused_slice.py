"""Fused primitive slice application: hand-written CUDA kernels + wrappers.

Both entries replace the TPU kernel ``fused_primitive_pallas``
(``src/repro/kernels/fused_slice.py``, body ``_kernel``), which the
reference scheduler calls once per superstep over the whole burst.  Each
row with flags (recv, reduce, reads_in, op) computes

    value = op(payload, local)   in f32, rounded back   if reduce
          = payload                                     elif recv
          = local                                       elif reads_in
          = 0                                           otherwise

(op 0 sum, 1 max, 2 min, 3 prod, clipped to 0..3; max/min propagate NaN).

* :func:`fused_burst` — the scheduler's main path, one launch per
  superstep.  It executes the whole slice burst of ``lanes_step`` (the
  reference's ``src/repro/core/scheduler.py:564-620`` and the outbox cast
  at :789): it reads each lane's connector slots and ``heap_in`` window
  itself, writes the lane's ``heap_out`` window in place (later lanes win
  where two overlap) and returns the outbox payload.  Its plain version,
  :func:`fused_burst_plain`, is that block of the scheduler as it was, in
  PyTorch ops, and is what the CPU takes.
* :func:`fused_primitive` — the one-to-one counterpart of the Pallas
  contract over given ``[N, S]`` rows and ``[N, 4]`` flags.  No runtime
  path calls it; it stays as the kernel's own contract, with its tests.

The CUDA source of both is ``src/repro_torch/csrc/fused_primitive.cu``
(sm_90a), whose note says what bounds each on the card (memory traffic,
at the scheduler's sizes the latency of the launch and of its dependent
loads) and what the design does about it.

Build: the shared ``nvcc`` + ``ctypes`` route of :mod:`._build`
(``build/kernels/``, at first use); the launch check is the C function's
``cudaGetLastError()`` return, raised on by the wrapper.

Dispatch: each wrapper launches its kernel for CUDA tensors and takes its
plain version only for CPU tensors — there is no fallback from the card.
``fused_burst.launches`` and ``fused_primitive.launches`` count kernel
launches and nothing else: one per call that launches.  When the daemon
replays supersteps captured in a CUDA graph (``core/daemon.py``
``_ChunkRunner``), each replay adds the ``fused_burst`` launches this
wrapper counted while the chunk was captured; the capture itself runs
nothing and is not counted.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    lib.occl_fused_primitive.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.occl_fused_primitive.restype = ctypes.c_int
    lib.occl_fused_burst.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    lib.occl_fused_burst.restype = ctypes.c_int


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


# ---------------------------------------------------------------------------
# the superstep burst
# ---------------------------------------------------------------------------

class BurstLanes(NamedTuple):
    """One superstep's burst descriptor per rank and lane: [R, L] int32
    tensors, ``write`` bool."""

    coll: torch.Tensor     # the lane's collective c, in [0, C)
    tail: torch.Tensor     # recv-connector tail of c (first slot read)
    rnd: torch.Tensor      # ctx_round of c
    sl: torch.Tensor       # ctx_slice of c
    chunk: torch.Tensor    # chunk of c's current program step
    prim: torch.Tensor     # primitive of that step (index of prim_*)
    n: torch.Tensor        # burst size (rows b < n are written)
    write: torch.Tensor    # the lane writes heap_out (copy, gated, live)


class BurstTables(NamedTuple):
    """The tables the burst reads by collective and by primitive."""

    in_off: torch.Tensor       # [R, C] int32
    out_off: torch.Tensor      # [R, C] int32
    n_rounds: torch.Tensor     # [C] int32
    n_slices: torch.Tensor     # [C] int32
    in_chunked: torch.Tensor   # [C] int32
    out_chunked: torch.Tensor  # [C] int32
    op: torch.Tensor           # [C] int32
    prim_recv: torch.Tensor    # [P] int32
    prim_reduce: torch.Tensor  # [P] int32
    prim_reads_in: torch.Tensor  # [P] int32


def _window_index(base: torch.Tensor, width: int, heap_len: int
                  ) -> torch.Tensor:
    """[R, width] int64 indices of the ``lax.dynamic_slice`` window starting
    at ``base`` [R]: a negative start counts from the end of the row (JAX's
    negative-index rule), then the start is clamped so the window fits."""
    start = torch.where(base < 0, base + heap_len, base)
    start = torch.clamp(start, 0, heap_len - width).long()
    return start[:, None] + torch.arange(width, device=base.device)


def fused_burst_plain(payload: torch.Tensor, heap_in: torch.Tensor,
                      heap_out: torch.Tensor, burst: int, lanes: BurstLanes,
                      tables: BurstTables) -> torch.Tensor:
    """Plain PyTorch version: the scheduler's burst block in tensor ops —
    gather the slot rows and the ``heap_in`` windows, the where-chain of
    :func:`fused_primitive_plain`, then one gather / blend / scatter of
    each lane's ``heap_out`` window in lane order.  Writes ``heap_out`` in
    place; returns the outbox payload [R, L, B, SL]."""
    K, SL, B = payload.shape[2], payload.shape[3], burst
    R, L = lanes.coll.shape
    dev = payload.device
    rr = torch.arange(R, device=dev)[:, None]
    bidx = torch.arange(B, device=dev, dtype=torch.int32)
    cl = lanes.coll.long()
    primi = lanes.prim.long()

    slots = ((lanes.tail[:, :, None] + bidx) % K).long()       # [R, L, B]
    recv_val = payload[rr[:, :, None], cl[:, :, None], slots]
    nsl = tables.n_slices[cl]
    chunk_stride = tables.n_rounds[cl] * nsl * SL
    within = (lanes.rnd * nsl + lanes.sl) * SL
    in_base = (torch.gather(tables.in_off, 1, cl)
               + torch.where(tables.in_chunked[cl] > 0, lanes.chunk, 0)
               * chunk_stride + within)
    out_base = (torch.gather(tables.out_off, 1, cl)
                + torch.where(tables.out_chunked[cl] > 0, lanes.chunk, 0)
                * chunk_stride + within)
    W = B * SL
    H = heap_in.shape[1]
    in_idx = torch.cat([_window_index(in_base[:, l], W, H)
                        for l in range(L)], dim=1)            # [R, L*W]
    in_val = torch.gather(heap_in, 1, in_idx).reshape(R, L, B, SL)

    flags = torch.stack([(tables.prim_recv[primi] > 0).to(torch.int32),
                         (tables.prim_reduce[primi] > 0).to(torch.int32),
                         (tables.prim_reads_in[primi] > 0).to(torch.int32),
                         tables.op[cl]], dim=-1)
    flags = flags[:, :, None, :].expand(R, L, B, 4).reshape(R * L * B, 4)
    value = fused_primitive_plain(
        recv_val.reshape(R * L * B, SL), in_val.reshape(R * L * B, SL),
        flags.contiguous()).reshape(R, L, B, SL)

    # Per-lane [B*SL] read-modify-write windows, in lane order (a later
    # lane's window wins where two overlap, as in the reference's
    # sequential dynamic_update_slice loop), updated in place.
    out_limit = torch.where(lanes.write, lanes.n, 0) * SL      # [R, L]
    vals = value.reshape(R, L, W).to(heap_out.dtype)
    span = torch.arange(W, device=dev)
    for l in range(L):
        idx = _window_index(out_base[:, l], W, H)
        window = torch.gather(heap_out, 1, idx)
        blend = torch.where(span[None, :] < out_limit[:, l, None],
                            vals[:, l], window)
        heap_out.scatter_(1, idx, blend)
    return value.to(payload.dtype)


def _check_burst(payload, heap_in, heap_out, burst, lanes, tables) -> None:
    if payload.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_burst: unsupported dtype {payload.dtype}")
    if not (heap_in.dtype == heap_out.dtype == payload.dtype):
        raise TypeError(f"fused_burst: payload, heap_in and heap_out must "
                        f"share one dtype, got {payload.dtype}, "
                        f"{heap_in.dtype}, {heap_out.dtype}")
    if payload.dim() != 4:
        raise ValueError(f"fused_burst: payload must be [R, C, K, SL], got "
                         f"{tuple(payload.shape)}")
    R, C, _, SL = payload.shape
    if heap_in.dim() != 2 or heap_in.shape != heap_out.shape \
            or heap_in.shape[0] != R:
        raise ValueError(f"fused_burst: heaps must be one [R, H] shape, got "
                         f"{tuple(heap_in.shape)} / {tuple(heap_out.shape)}")
    if not 1 <= burst or heap_in.shape[1] < burst * SL:
        raise ValueError(f"fused_burst: a burst of {burst} x {SL} does not "
                         f"fit a heap row of {heap_in.shape[1]}")
    RL = tuple(lanes.coll.shape)
    if len(RL) != 2 or RL[0] != R:
        raise ValueError(f"fused_burst: lanes must be [R, L], got {RL}")
    P = tables.prim_recv.shape
    want = {**{f: RL for f in BurstLanes._fields},
            "in_off": (R, C), "out_off": (R, C),
            **{f: (C,) for f in ("n_rounds", "n_slices", "in_chunked",
                                 "out_chunked", "op")},
            **{f: P for f in ("prim_recv", "prim_reduce", "prim_reads_in")}}
    named = {**lanes._asdict(), **tables._asdict()}
    for f, t in named.items():
        dt = torch.bool if f == "write" else torch.int32
        if t.dtype != dt:
            raise TypeError(f"fused_burst: {f} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != want[f]:
            raise ValueError(f"fused_burst: {f} must be {want[f]}, got "
                             f"{tuple(t.shape)}")
    if len(P) != 1 or P[0] < 1:
        raise ValueError(f"fused_burst: prim tables must be [P], got {P}")
    tensors = (payload, heap_in, heap_out, *named.values())
    # The connector may be a view with a padded rank stride (the inbox
    # commit slices its sentinel row off); each rank's [C, K, SL] block
    # must be contiguous.
    K = payload.shape[2]
    if payload.stride()[1:] != (K * SL, SL, 1) \
            or payload.stride(0) < C * K * SL \
            or not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("fused_burst: inputs must be contiguous (payload "
                         "within each rank)")
    if any(t.device != payload.device for t in tensors):
        raise ValueError("fused_burst: inputs on different devices")
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_burst: unsupported device {payload.device}")
    if heap_in.untyped_storage().data_ptr() \
            == heap_out.untyped_storage().data_ptr():
        raise ValueError("fused_burst: heap_in and heap_out share storage")


def fused_burst(payload: torch.Tensor, heap_in: torch.Tensor,
                heap_out: torch.Tensor, burst: int, lanes: BurstLanes,
                tables: BurstTables) -> torch.Tensor:
    """One superstep's slice burst.  payload [R, C, K, SL] (contiguous
    within each rank), heap_in / heap_out [R, H] (one float dtype,
    contiguous; heap_out written in place), ``burst`` = B -> outbox payload [R, L, B, SL].  CUDA tensors
    launch the kernel on the current stream; CPU tensors take the plain
    version."""
    _check_burst(payload, heap_in, heap_out, burst, lanes, tables)
    if payload.device.type == "cpu":
        return fused_burst_plain(payload, heap_in, heap_out, burst, lanes,
                                 tables)
    R, C, K, SL = payload.shape
    L = lanes.coll.shape[1]
    out = torch.empty((R, L, burst, SL), dtype=payload.dtype,
                      device=payload.device)
    if out.numel() == 0:
        return out
    lane_ptrs = (ctypes.c_void_p * len(lanes))(*(t.data_ptr() for t in lanes))
    table_ptrs = (ctypes.c_void_p * len(tables))(
        *(t.data_ptr() for t in tables))
    dims = (ctypes.c_int * 7)(R, L, burst, C, K, SL,
                              tables.prim_recv.shape[0])
    err = LIBRARY.load().occl_fused_burst(
        payload.data_ptr(), payload.stride(0), heap_in.data_ptr(),
        heap_out.data_ptr(), out.data_ptr(), lane_ptrs, table_ptrs, dims,
        heap_in.shape[1],
        _DTYPE_CODES[payload.dtype],
        torch.cuda.current_stream(payload.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_burst kernel launch failed: CUDA error "
                           f"{err}")
    fused_burst.launches += 1
    return out


fused_burst.launches = 0
