"""Daemon state: dynamic contexts, connectors, task queue, SQ/CQ mirrors.

PyTorch port of ``repro.core.state``.  Every field is a fixed-shape tensor
with the leading ``[R]`` rank axis written out (the sim backend: all ranks
live on one device); the mesh backend keeps one such state per rank, with
a leading axis of 1, on that rank's device (:class:`ShardedState`).  The
same field names, shapes and dtypes as the reference's per-rank-stacked
state, so :func:`state_from_numpy` / :func:`state_to_numpy` carry a state
across the two packages leaf by leaf.

Connector representation (paper Fig. 3, Sec. 2.3): the connector between
ring-neighbors ``r -> next(r)`` is a lock-free ring buffer of ``K`` slice
slots.  The *writer* owns the committed-write counter ``head`` and a lagging
mirror of the reader's ``tail`` (credits); the *reader* owns ``tail``, a
lagging mirror of ``head`` and the payload slots.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import OcclConfig
from .recorder import N_EVENT_KINDS

# Heap / wire dtypes by config name.
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}

_NUMPY_DTYPES = {torch.int32: np.dtype(np.int32),
                 torch.float32: np.dtype(np.float32),
                 torch.bool: np.dtype(np.bool_)}


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``None`` means ``cuda`` and raises when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def heap_scratch_elems(cfg: OcclConfig) -> int:
    """Physical heap padding past the allocatable region: the scheduler's
    per-lane [B*SLICE] burst windows must never clamp-shift at the top of
    the heap.  Logical offsets handed out by the runtime — and every
    staging-engine index — stay < heap_elems; only the daemon's windowed
    slices may graze the scratch tail."""
    return cfg.burst_slices * cfg.slice_elems


class DaemonState(NamedTuple):
    # --- data heap (send/recv buffers; addresses = heap offsets) --------
    # heap_in is written by staging.StagingEngine, heap_out by the
    # daemon's burst windows — both IN PLACE (the reference threads them
    # functionally and relies on buffer donation / loop-carry aliasing for
    # the same effect).
    heap_in: torch.Tensor       # [R, H + pad]
    heap_out: torch.Tensor      # [R, H + pad]

    # --- connectors (per collective; dedicated, paper Sec. 5.1) ---------
    head: torch.Tensor          # [R, C] i32 — my committed writes
    tail_mirror: torch.Tensor   # [R, C] i32 — reader's consumed count
    head_mirror: torch.Tensor   # [R, C] i32 — upstream's commits
    tail: torch.Tensor          # [R, C] i32 — my consumed count
    payload: torch.Tensor       # [R, C, K, SLICE] — recv-connector slots

    # --- task queue + dynamic contexts (paper Sec. 3.1.1) ---------------
    tq_active: torch.Tensor     # [R, C] bool — in my task queue
    arrival: torch.Tensor       # [R, C] i32 — queue-order key
    prio: torch.Tensor          # [R, C] i32 — user priority (SQE)
    cur: torch.Tensor           # [R, L] i32 — executing collective (-1)
    ctx_step: torch.Tensor      # [R, C] i32 — primitive index
    ctx_slice: torch.Tensor     # [R, C] i32 — slice index inside the chunk
    ctx_round: torch.Tensor     # [R, C] i32 — primitive-sequence repetition
    spin: torch.Tensor          # [R, C] i32 — current primitive's spin count
    boost: torch.Tensor         # [R, C] i32 — stickiness boost
    in_off: torch.Tensor        # [R, C] i32 — live buffer addresses
    out_off: torch.Tensor       # [R, C] i32

    # --- SQ / CQ (paper Sec. 3.1.2) --------------------------------------
    sq_coll: torch.Tensor       # [R, SQL] i32
    sq_prio: torch.Tensor       # [R, SQL] i32
    sq_in: torch.Tensor         # [R, SQL] i32 (-1 = registered default)
    sq_out: torch.Tensor        # [R, SQL] i32
    sq_size: torch.Tensor       # [R] i32 — valid SQEs
    sq_read: torch.Tensor       # [R] i32 — daemon cursor
    cq_coll: torch.Tensor       # [R, CQL] i32
    cq_count: torch.Tensor      # [R] i32
    inflight: torch.Tensor      # [R, C] bool — submitted, not completed

    # --- in-flight connector messages (survive daemon relaunch) ---------
    mb_fwd_count: torch.Tensor    # [R, L] i32
    mb_fwd_coll: torch.Tensor     # [R, L] i32
    mb_fwd_payload: torch.Tensor  # [R, L, B, SLICE]
    mb_rev_count: torch.Tensor    # [R, L] i32
    mb_rev_coll: torch.Tensor     # [R, L] i32

    # --- counters / lifecycle --------------------------------------------
    completed: torch.Tensor     # [R, C] i32 — logical completions
    stage_completions: torch.Tensor  # [R, C] i32 — per-stage completions
    preempts: torch.Tensor      # [R, C] i32 — context switches (Fig. 9)
    stall_slices: torch.Tensor  # [R, C] i32 — burst slices denied
    qlen_at_fetch: torch.Tensor # [R, C] i32 — queue length at SQE fetch
    supersteps: torch.Tensor    # [R] i32 — cumulative epoch clock
    launch_steps: torch.Tensor  # [R] i32 — per-launch clock
    epoch: torch.Tensor         # [R] i32 — daemon launch counter
    no_prog: torch.Tensor       # [R] i32 — consecutive no-progress steps
    made_prog_prev: torch.Tensor  # [R] bool — lazy-fetch gate input
    slices_moved: torch.Tensor  # [R] i32 — work counter
    global_live: torch.Tensor   # [R] bool — fabric-wide continue flag

    # --- tick observability -----------------------------------------------
    fetch_step: torch.Tensor    # [R, C] i32 — supersteps stamp at entry
    rtc_latency: torch.Tensor   # [R, C] i32 — cumulative ready-to-complete
    rtc_events: torch.Tensor    # [R, C] i32 — completions accounted
    tick_calls: torch.Tensor    # [R] i32
    overlap_steps: torch.Tensor # [R] i32
    barrier_steps: torch.Tensor # [R] i32

    # --- flight recorder (core/recorder.py; cfg.flight_recorder) ---------
    fr_kind: torch.Tensor       # [R, FR] i32 — event kind (-1 = empty)
    fr_coll: torch.Tensor       # [R, FR] i32
    fr_step: torch.Tensor       # [R, FR] i32 — epoch-clock stamp
    fr_count: torch.Tensor      # [R] i32 — events appended
    fr_kinds: torch.Tensor      # [R, N_EVENT_KINDS] i32


def resolve_mesh(mesh, n_ranks: int) -> tuple:
    """The mesh backend's devices: one per rank (``mesh[r]`` holds rank r's
    state), each resolved as :func:`resolve_device` does (a CUDA entry
    raises without a card) and given its index, so two entries naming one
    card compare equal.  Raises on a length other than ``n_ranks``, as the
    reference's ``shard_map`` does on a mesh axis of another size."""
    devs = tuple(resolve_device(d) for d in mesh)
    if len(devs) != n_ranks:
        raise ValueError(f"mesh has {len(devs)} devices, cfg.n_ranks is "
                         f"{n_ranks}: the mesh needs one device per rank")
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)


def init_state(cfg: OcclConfig, device=None, sharding=None):
    """Fresh [R, ...] state on ``device``; with ``sharding`` (the mesh
    backend: one device per rank, :func:`resolve_mesh`), a
    :class:`ShardedState` whose rank r has its own leaves, with a leading
    axis of 1, on ``sharding[r]``."""
    if sharding is not None:
        return ShardedState(_init_state(cfg, d, 1) for d in sharding)
    return _init_state(cfg, device, cfg.n_ranks)


def _init_state(cfg: OcclConfig, device, R: int) -> DaemonState:
    C, K, L = cfg.max_colls, cfg.conn_depth, cfg.max_comms
    B = cfg.burst_slices
    SQL, CQL, H, SL = cfg.sq_len, cfg.cq_len, cfg.heap_elems, cfg.slice_elems
    dt = TORCH_DTYPES[cfg.dtype]

    def z(shape, dtype=torch.int32, fill=0):
        return torch.full((R,) + shape, fill, dtype=dtype, device=device)

    pad = heap_scratch_elems(cfg)
    return DaemonState(
        heap_in=z((H + pad,), dt),
        heap_out=z((H + pad,), dt),
        head=z((C,)), tail_mirror=z((C,)), head_mirror=z((C,)), tail=z((C,)),
        payload=z((C, K, SL), dt),
        tq_active=z((C,), torch.bool, False),
        arrival=z((C,)),
        prio=z((C,)),
        cur=z((L,), torch.int32, -1),
        ctx_step=z((C,)), ctx_slice=z((C,)), ctx_round=z((C,)),
        spin=z((C,)), boost=z((C,)),
        in_off=z((C,)), out_off=z((C,)),
        sq_coll=z((SQL,), torch.int32, -1), sq_prio=z((SQL,)),
        sq_in=z((SQL,), torch.int32, -1), sq_out=z((SQL,), torch.int32, -1),
        sq_size=z(()), sq_read=z(()),
        cq_coll=z((CQL,), torch.int32, -1), cq_count=z(()),
        inflight=z((C,), torch.bool, False),
        mb_fwd_count=z((L,)),
        mb_fwd_coll=z((L,)),
        mb_fwd_payload=z((L, B, SL), dt),
        mb_rev_count=z((L,)),
        mb_rev_coll=z((L,)),
        completed=z((C,)), stage_completions=z((C,)),
        preempts=z((C,)), stall_slices=z((C,)),
        qlen_at_fetch=z((C,)),
        supersteps=z(()), launch_steps=z(()), epoch=z(()), no_prog=z(()),
        made_prog_prev=z((), torch.bool, False),
        slices_moved=z(()),
        global_live=z((), torch.bool, True),
        fetch_step=z((C,)), rtc_latency=z((C,)), rtc_events=z((C,)),
        tick_calls=z(()), overlap_steps=z(()), barrier_steps=z(()),
        fr_kind=z((cfg.recorder_len,), torch.int32, -1),
        fr_coll=z((cfg.recorder_len,), torch.int32, -1),
        fr_step=z((cfg.recorder_len,)),
        fr_count=z(()),
        fr_kinds=z((N_EVENT_KINDS,)),
    )


class ShardedState:
    """The mesh backend's state: rank r's :class:`DaemonState` on its own
    device, every leaf with a leading axis of 1 (the reference's [R, ...]
    arrays sharded along the mesh's rank axis).

    Reading a field gathers the [R, ...] view onto the first rank's device
    (what the reference's sharded array shows its readers: the SQ/CQ
    reconcile, ``stats``, the recorder export); :meth:`gather` gathers every
    leaf.  ``_replace`` takes [R, ...] tensors and places each rank's row on
    that rank's device."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    def __getattr__(self, name):
        if name not in DaemonState._fields:
            raise AttributeError(name)
        dev = self.shards[0].global_live.device
        return torch.cat([getattr(s, name).to(dev) for s in self.shards])

    def gather(self) -> DaemonState:
        """The whole state as one [R, ...] DaemonState (copies)."""
        return DaemonState(*(getattr(self, f) for f in DaemonState._fields))

    def _replace(self, **fields) -> "ShardedState":
        return ShardedState(
            s._replace(**{f: v[r:r + 1].to(getattr(s, f).device)
                          for f, v in fields.items()})
            for r, s in enumerate(self.shards))


def _leaf_from_numpy(a: np.ndarray, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """One numpy leaf -> tensor of ``dtype``; 16-bit floats travel as their
    raw bit patterns (any 2-byte numpy dtype, e.g. ``ml_dtypes.bfloat16``
    or ``uint16``), so no value is ever re-rounded on the way."""
    a = np.ascontiguousarray(a)
    if dtype in (torch.bfloat16, torch.float16):
        if a.dtype.itemsize != 2:
            raise TypeError(f"{dtype} leaf needs 2-byte bit patterns, got "
                            f"{a.dtype}")
        t = torch.from_numpy(a.view(np.int16).copy()).view(dtype)
    else:
        if a.dtype != _NUMPY_DTYPES[dtype]:
            raise TypeError(f"expected {_NUMPY_DTYPES[dtype]}, got {a.dtype}")
        t = torch.from_numpy(a.copy())
    return t.to(device)


def state_from_numpy(arrays, cfg: OcclConfig, device) -> DaemonState:
    """Build a port state from numpy leaves: a mapping or NamedTuple with
    the :class:`DaemonState` field names and the reference's [R, ...]
    shapes (e.g. the JAX package's state, each leaf through
    ``np.asarray``).  The counterpart of carrying weights across."""
    d = arrays._asdict() if hasattr(arrays, "_asdict") else dict(arrays)
    ref = init_state(cfg, "meta")
    out = {}
    for f in DaemonState._fields:
        a = np.asarray(d[f])
        want = getattr(ref, f)
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"{f}: shape {a.shape}, config needs "
                             f"{tuple(want.shape)}")
        out[f] = _leaf_from_numpy(a, want.dtype, device)
    return DaemonState(**out)


def state_to_numpy(st: DaemonState) -> dict:
    """Port state -> {field: numpy array}; 16-bit float leaves come back as
    their raw ``uint16`` bit patterns (numpy has no bfloat16)."""
    out = {}
    for f, t in st._asdict().items():
        t = t.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            out[f] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[f] = t.numpy()
    return out


def tables_from_numpy(t, device):
    """Static tables (the port's or the reference's ``StaticTables``: any
    object with the same numpy fields) -> ``(SharedTables, LocalTables,
    fwd_src, rev_src)`` tensors on ``device``."""
    from .daemon import local_tables, shared_tables

    return (shared_tables(t, device), local_tables(t, device),
            torch.as_tensor(np.asarray(t.fwd_src), dtype=torch.int64,
                            device=device),
            torch.as_tensor(np.asarray(t.rev_src), dtype=torch.int64,
                            device=device))
