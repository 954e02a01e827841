"""The sim daemon's gated superstep: two hand-written CUDA kernels around
``fused_burst``.

:func:`fused_superstep` launches ONE gated superstep of the sim backend over
all ranks on CUDA tensors: the scheduler's phases A-C (``core/scheduler.py``
``rank_superstep`` with the relink deferred), the ring exchange and the
liveness vote, every write gated on the ``global_live`` the superstep started
from (``core/daemon.py`` ``_sim_body_fn``, the plain version, which the daemon
runs on the CPU).  That is three launches instead of about 620 PyTorch ops:

* ``superstep_select_kernel`` (``csrc/superstep.cu``): the inbox's counts
  and the commit of its payload rows into their connector slots, the SQ
  fetch, each lane's keys, positions, thresholds, preempt rotation, queue
  front and burst quota; it writes the burst's lane descriptors;
* ``fused_burst_kernel`` through :func:`~.fused_slice.fused_burst`, as
  before, on those descriptors;
* ``superstep_finish_kernel``: the context advance, completion and chain
  advance, the CQ, the flight recorder, the per-rank counters, the
  exchange of counts, collective ids and payload rows, and the vote.

The kernels update the state's and the mailbox's tensors IN PLACE.  With
``chains`` finish also writes the ``[R, C]`` mask of the chain hand-offs
that fired, which is returned for the daemon's relink.  The kernels take
``global_live`` as one value on every rank, as every writer of it keeps it.

The sizes are read from the tensors; the scalar settings come in a
:class:`Settings` (the daemon makes it from the ``OcclConfig``).

``fused_superstep.launches`` counts the two kernels' launches (two per
call); like ``fused_burst.launches``, a CUDA graph replay of captured
supersteps adds the launches counted while the chunk was captured
(``daemon._ChunkRunner``).

Build: the shared ``nvcc`` + ``ctypes`` route of :mod:`._build`; each entry
returns ``cudaGetLastError()``, raised on here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .fused_slice import BurstLanes, BurstTables, fused_burst

# Per-lane values select hands to finish (csrc/superstep.cu ``Aux``) and the
# BurstLanes int fields it writes (``LaneField``).
N_AUX = 17
N_LANE_FIELDS = 7
N_PTRS = 79
N_DIMS = 35
HEAP_DTYPES = (torch.float32, torch.bfloat16)


class Settings(NamedTuple):
    """The superstep's scalar settings, in the order of the source's
    ``Args`` after the sizes: the configuration's flags and spin, quit and
    budget values, the queue keys' strides, ``Prim.NULL`` and the flight
    recorder's event kinds."""
    flight_recorder: int
    priority: int
    priority_preempts: int
    prio_aging_quantum: int
    prio_aging_cap: int
    stickiness: int
    demand_steering: int
    queue_conditional_stall: int
    spin_base: int
    spin_decr: int
    spin_boost: int
    spin_min: int
    spin_max: int
    quit_threshold: int
    superstep_budget: int
    demand_stride: int
    prio_stride: int
    prim_null: int
    ev_submit: int
    ev_stage_done: int
    ev_preempt: int
    ev_chain_handoff: int
    ev_cqe: int


_I32, _BOOL, _I64 = torch.int32, torch.bool, torch.int64

# The state leaves the kernels read or write, in the order of their
# pointers (csrc/superstep.cu ``Args``), with dtype and shape: "RC" [R, C],
# "RL" [R, L], "R" [R], "RQ" [R, SQ], "RCQ" [R, CQ], "RF" [R, FR],
# "RK" [R, N_EVENT_KINDS]; "pay" is the connector [R, C, K, SL].
_STATE = (
    ("head", _I32, "RC"), ("tail_mirror", _I32, "RC"),
    ("head_mirror", _I32, "RC"), ("tail", _I32, "RC"),
    ("payload", None, "pay"), ("tq_active", _BOOL, "RC"),
    ("arrival", _I32, "RC"), ("prio", _I32, "RC"), ("cur", _I32, "RL"),
    ("ctx_step", _I32, "RC"), ("ctx_slice", _I32, "RC"),
    ("ctx_round", _I32, "RC"), ("spin", _I32, "RC"), ("boost", _I32, "RC"),
    ("in_off", _I32, "RC"), ("out_off", _I32, "RC"),
    ("sq_coll", _I32, "RQ"), ("sq_prio", _I32, "RQ"), ("sq_in", _I32, "RQ"),
    ("sq_out", _I32, "RQ"), ("sq_size", _I32, "R"), ("sq_read", _I32, "R"),
    ("cq_coll", _I32, "RCQ"), ("cq_count", _I32, "R"),
    ("inflight", _BOOL, "RC"), ("completed", _I32, "RC"),
    ("stage_completions", _I32, "RC"), ("preempts", _I32, "RC"),
    ("stall_slices", _I32, "RC"), ("qlen_at_fetch", _I32, "RC"),
    ("supersteps", _I32, "R"), ("launch_steps", _I32, "R"),
    ("no_prog", _I32, "R"), ("made_prog_prev", _BOOL, "R"),
    ("slices_moved", _I32, "R"), ("global_live", _BOOL, "R"),
    ("fetch_step", _I32, "RC"), ("rtc_latency", _I32, "RC"),
    ("rtc_events", _I32, "RC"), ("fr_kind", _I32, "RF"),
    ("fr_coll", _I32, "RF"), ("fr_step", _I32, "RF"), ("fr_count", _I32, "R"),
    ("fr_kinds", _I32, "RK"),
)
_MAILBOX = (("fwd_count", _I32, "RL"), ("fwd_coll", _I32, "RL"),
            ("fwd_payload", None, "RLB"), ("rev_count", _I32, "RL"),
            ("rev_coll", _I32, "RL"))
# Shared tables the kernels read ("C" [C], "L" [L], "CC" [C, C], "P"
# [len(Prim)]); then the ones only the burst reads.
_SHARED = (("registered", _BOOL, "C"), ("lane", _I32, "C"),
           ("lane_caps", _I32, "L"), ("n_steps", _I32, "C"),
           ("n_slices", _I32, "C"), ("n_rounds", _I32, "C"),
           ("base_in_off", _I32, "C"), ("base_out_off", _I32, "C"),
           ("next_coll", _I32, "C"), ("chain_tail", _I32, "C"),
           ("chain_prio_inherit", _BOOL, "C"), ("chain_mask", _BOOL, "CC"),
           ("prim_recv", _I32, "P"), ("prim_send", _I32, "P"),
           ("prim_copy", _I32, "P"))
_SHARED_BURST = (("op", _I32, "C"),
                 ("in_chunked", _I32, "C"), ("out_chunked", _I32, "C"),
                 ("prim_reduce", _I32, "P"), ("prim_reads_in", _I32, "P"))
_LOCAL = (("member", _BOOL, "RC"), ("prog_kind", _I32, "RCS"),
          ("prog_chunk", _I32, "RCS"), ("chain_next", _I32, "RC"),
          ("chain_tail_r", _I32, "RC"))


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("occl_superstep_select", "occl_superstep_finish"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


LIBRARY = _build.Library("superstep.cu", _bind)


def _sizes(sh, lt, st, inbox) -> dict:
    """Each shape name's sizes, read from the tensors that define them."""
    dim = lambda t, i: t.shape[i] if t.dim() > i else -1
    R, C = dim(st.head, 0), dim(st.head, 1)
    L, B = dim(st.cur, 1), dim(inbox.fwd_payload, 2)
    K, SL = dim(st.payload, 2), dim(st.payload, 3)
    return {"R": (R,), "C": (C,), "L": (L,), "RC": (R, C), "RL": (R, L),
            "CC": (C, C), "P": (dim(sh.prim_recv, 0),),
            "RCS": (R, C, dim(lt.prog_kind, 2)),
            "RQ": (R, dim(st.sq_coll, 1)), "RCQ": (R, dim(st.cq_coll, 1)),
            "RF": (R, dim(st.fr_kind, 1)), "RK": (R, dim(st.fr_kinds, 1)),
            "pay": (R, C, K, SL), "RLB": (R, L, B, SL), "LR": (L, R)}


def _check(sh, lt, fwd_src, rev_src, st, inbox, steps) -> dict:
    """Raise on what the kernels do not take; returns the sizes."""
    heap_dt = st.heap_in.dtype
    if heap_dt not in HEAP_DTYPES:
        raise TypeError(f"fused_superstep: unsupported heap dtype {heap_dt}")
    dims = _sizes(sh, lt, st, inbox)
    named = ([(f, getattr(st, f), dt, sh_) for f, dt, sh_ in _STATE]
             + [(f"inbox.{f}", getattr(inbox, f), dt, sh_)
                for f, dt, sh_ in _MAILBOX]
             + [(f, getattr(sh, f), dt, sh_)
                for f, dt, sh_ in _SHARED + _SHARED_BURST]
             + [(f, getattr(lt, f), dt, sh_) for f, dt, sh_ in _LOCAL]
             + [("fwd_src", fwd_src, _I64, "LR"),
                ("rev_src", rev_src, _I64, "LR"),
                ("steps", steps, _I32, None)])
    for f, t, dt, shape in named:
        want = heap_dt if dt is None else dt
        if t.dtype != want:
            raise TypeError(f"fused_superstep: {f} must be {want}, got "
                            f"{t.dtype}")
        want_shape = () if shape is None else dims[shape]
        if tuple(t.shape) != want_shape:
            raise ValueError(f"fused_superstep: {f} must be {want_shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_superstep: {f} must be contiguous")
    heaps = [st.heap_in, st.heap_out]
    for f, t in zip(("heap_in", "heap_out"), heaps):
        if t.dtype != heap_dt or t.dim() != 2 or t.shape[0] != dims["R"][0]:
            raise ValueError(f"fused_superstep: {f} must be [R, H] of "
                             f"{heap_dt}, got {tuple(t.shape)} {t.dtype}")
    dev = st.global_live.device
    if any(t.device != dev for _, t, _, _ in named) \
            or any(t.device != dev for t in heaps):
        raise ValueError("fused_superstep: inputs on different devices")
    if dev.type != "cuda":
        raise ValueError(f"fused_superstep: unsupported device {dev}")
    return dims


def _dims(dims: dict, settings: Settings, chains: bool) -> list:
    """The source's ``Args`` sizes and values, in order."""
    R, C, K, SL = dims["pay"]
    L, B = dims["RLB"][1:3]
    return [R, C, L, B, K, dims["RCS"][2], dims["P"][0], dims["RQ"][1],
            dims["RCQ"][1], dims["RF"][1], *settings, dims["RK"][1],
            int(chains)]


def _copy_unit(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit (16 bytes down to 1) that divides a payload row
    and both payload pointers."""
    return next(unit for unit in (16, 8, 4, 2, 1)
                if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs))


def fused_superstep(settings: Settings, sh, lt, fwd_src, rev_src, st,
                    inbox, steps, chains: bool = False):
    """ONE gated sim superstep of every rank, on CUDA tensors, IN PLACE.

    ``settings`` the scalar settings, ``sh`` / ``lt`` the shared and
    per-rank tables, ``fwd_src`` / ``rev_src`` [L, R] int64 the exchange's
    rings, ``st`` the DaemonState, ``inbox`` the Mailbox in flight,
    ``steps`` a [] int32 count the superstep's starting live flag (rank
    0's) is added to.  Launches select, the burst and finish on the current
    stream; updates ``st``, ``inbox``, ``steps`` and the heaps.  Returns the
    [R, C] bool mask of the chain hand-offs that fired where ``chains``
    (the registration has relink edges), else None."""
    dims = _check(sh, lt, fwd_src, rev_src, st, inbox, steps)
    dev = st.global_live.device
    return _launch(LIBRARY.load(), torch.cuda.current_stream(dev).cuda_stream,
                   _dims(dims, settings, chains), sh, lt, fwd_src, rev_src,
                   st, inbox, steps)


def _launch(lib, stream, dims: list, sh, lt, fwd_src, rev_src, st, inbox,
            steps):
    """Select, the burst and finish on checked inputs: scratch allocated
    here, pointers and sizes in the order of the source's ``Args``."""
    dev = st.global_live.device
    R, C, L, B = dims[:4]
    RL, RC = R * L, R * C
    chains = bool(dims[-1])
    buf = torch.empty((N_LANE_FIELDS + N_AUX) * RL + 3 * R + 2 * RC,
                      dtype=_I32, device=dev)
    write = torch.empty((R, L), dtype=_BOOL, device=dev)
    fired = torch.empty((R, C) if chains else (1,), dtype=_BOOL, device=dev)
    lanes = BurstLanes(*(buf[i * RL:(i + 1) * RL].view(R, L)
                         for i in range(N_LANE_FIELDS)), write)
    aux = buf[N_LANE_FIELDS * RL:]
    raux = aux[N_AUX * RL:]
    mirrors = raux[3 * R:]
    ptrs = ([getattr(st, f).data_ptr() for f, _, _ in _STATE]
            + [getattr(inbox, f).data_ptr() for f, _, _ in _MAILBOX]
            + [getattr(sh, f).data_ptr() for f, _, _ in _SHARED]
            + [getattr(lt, f).data_ptr() for f, _, _ in _LOCAL]
            + [fwd_src.data_ptr(), rev_src.data_ptr(),
               buf.data_ptr(), write.data_ptr(), aux.data_ptr(),
               raux.data_ptr(), mirrors.data_ptr(), fired.data_ptr(),
               0, steps.data_ptr()])
    c_ptrs = (ctypes.c_void_p * N_PTRS)(*ptrs)
    c_dims = (ctypes.c_int * N_DIMS)(*dims)
    row_bytes = st.payload.shape[-1] * st.payload.element_size()
    unit = _copy_unit(row_bytes, st.payload.data_ptr(),
                      inbox.fwd_payload.data_ptr())
    _launched(lib.occl_superstep_select(c_ptrs, N_PTRS, c_dims, N_DIMS,
                                        row_bytes, unit, stream), "select")
    outbox = fused_burst(
        st.payload, st.heap_in, st.heap_out, B, lanes,
        BurstTables(st.in_off, st.out_off, sh.n_rounds, sh.n_slices,
                    sh.in_chunked, sh.out_chunked, sh.op, sh.prim_recv,
                    sh.prim_reduce, sh.prim_reads_in))
    c_ptrs[N_PTRS - 2] = outbox.data_ptr()
    unit = _copy_unit(row_bytes, outbox.data_ptr(),
                      inbox.fwd_payload.data_ptr())
    _launched(lib.occl_superstep_finish(c_ptrs, N_PTRS, c_dims, N_DIMS,
                                        row_bytes, unit, stream), "finish")
    return fired if chains else None


def _launched(err: int, which: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_superstep {which} kernel launch failed: "
                           f"CUDA error {err}")
    fused_superstep.launches += 1


fused_superstep.launches = 0
