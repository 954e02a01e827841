"""In-step submission and progress: the device-side OCCL API.

PyTorch port of ``repro.core.device_api``.  The host API
(:class:`~repro_torch.core.runtime.OcclRuntime`) submits SQEs from Python
and drives the daemon between steps.  This module is the same contract
INSIDE a step: functions over :class:`~repro_torch.core.state.DaemonState`
that write payloads into the heap, append SQEs, advance the daemon by
bounded ticks (:class:`~repro_torch.core.daemon.SimTicker`) and gather
results — what lets gradient buckets be submitted mid-backward
(``train/step.py``).

Conventions (sim backend; state leaves carry the leading [R] rank axis):

* Every method but :meth:`DeviceApi.tick_until` / :meth:`DeviceApi.drain`
  runs without a host read: the SQE append and the mid-step relaunch are
  device-side selects, so a tick can run inside a backward pass.  Those
  two read one flag per chunk to decide whether to tick again.
* The heaps are the runtime's own tensors, updated IN PLACE as everywhere
  in the port (:meth:`submit` writes ``heap_in``, ticks write both); the
  other leaves are rebuilt.  A tick of ``k`` supersteps replays one CUDA
  graph on the card; :meth:`step_prologue` captures the graphs of the
  tick sizes the step will use, so a backward pass only replays them.
* :meth:`DeviceApi.step_prologue` opens a step: it resets the SQ/CQ
  cursors (the in-step analogue of ``HostQueues.pack_sq``) and runs the
  daemon launch prologue.  Call it ONCE per step — mid-step relaunches
  after a voluntary quit reuse ``launch_prologue`` only (resetting
  ``sq_read`` would re-fetch already-consumed SQEs).
* :meth:`DeviceApi.submit` writes the padded heap span (pads zero-filled)
  and appends an SQE at ``sq_size`` — so per-step submissions per rank
  must fit ``cfg.sq_len`` (overflow drops the SQE and poisons nothing).
* :meth:`DeviceApi.tick` auto-relaunches (prologue) when the fabric went
  not-live with work still pending.
* :func:`encode_state` / :func:`decode_state` view the whole state as
  float32 leaves and back, losslessly (the reference threads a state
  through ``custom_vjp`` cotangents this way; the port's overlap step keeps
  the state in the step's own object instead and threads a token).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .daemon import TickFlags, _drained, _gate, launch_prologue
from .errors import EvictionError
from .state import DaemonState


# ---------------------------------------------------------------------------
# Lossless state <-> float32 encoding
# ---------------------------------------------------------------------------
def encode_state(st: DaemonState) -> DaemonState:
    """Every leaf as ``float32`` (losslessly; same structure): int32 and
    bool (via int32) leaves are bit views, 16-bit float heaps widen
    exactly."""
    def enc(a: torch.Tensor) -> torch.Tensor:
        if a.dtype == torch.bool:
            return a.to(torch.int32).view(torch.float32)
        if a.dtype == torch.int32:
            return a.view(torch.float32)
        if a.dtype in (torch.bfloat16, torch.float16):
            return a.to(torch.float32)
        assert a.dtype == torch.float32, a.dtype
        return a

    return DaemonState(*[enc(a) for a in st])


def decode_state(enc: DaemonState, like: DaemonState) -> DaemonState:
    """Inverse of :func:`encode_state`; ``like`` supplies target dtypes."""
    def dec(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
        if ref.dtype == torch.bool:
            return a.view(torch.int32) != 0
        if ref.dtype == torch.int32:
            return a.view(torch.int32)
        if ref.dtype != torch.float32:
            return a.to(ref.dtype)
        return a

    return DaemonState(*[dec(a, r) for a, r in zip(enc, like)])


def encoded_zeros(like: DaemonState) -> DaemonState:
    """An all-zero encoded state with the structure encode_state returns."""
    return DaemonState(*[torch.zeros(a.shape, dtype=torch.float32,
                                     device=a.device) for a in like])


class DeviceApi:
    """In-step submission/tick/read API over a built sim runtime.

    Construct it AFTER registration closed (the runtime's first launch or
    state touch closes it); it snapshots the runtime's tables, chain
    routing and heap layout and shares its superstep machine.  After the
    step, hand the final state back with ``runtime.adopt_state(st)`` so
    host-side reconciliation stays consistent."""

    def __init__(self, rt):
        rt._ensure_built()
        self.cfg = rt.cfg
        self._rt = rt
        # Elastic-shrink staleness stamp: runtime.evict() bumps the
        # generation and drops its DeviceApi; an api object the user kept
        # across the shrink still points at the old tables and heaps.
        self._generation = rt._generation
        self._t = rt._tables
        self._specs = list(rt.specs)
        self._entry_of = {h: dict(m) for h, m in rt._entry_of.items()}
        self._tail_of = dict(rt._tail_of)
        self._ticker = rt._ticker
        dev = rt.device
        self._ranks = torch.arange(self.cfg.n_ranks, device=dev)
        self._slots = torch.arange(self.cfg.sq_len, device=dev)
        self._in_maps: dict = {}
        self._out_maps: dict = {}

    @property
    def stale(self) -> bool:
        """True once ``runtime.evict()`` rebuilt past this snapshot."""
        return self._generation != self._rt._generation

    def _check_current(self) -> None:
        if self.stale:
            raise EvictionError(
                f"DeviceApi snapshot of generation {self._generation} is "
                f"stale: the runtime is at generation "
                f"{self._rt._generation} after evict() — fetch a fresh "
                "runtime.device_api()")

    # -- routing helpers ---------------------------------------------------
    def _out_cid(self, coll_id: int) -> int:
        return self._tail_of.get(coll_id, coll_id)

    def out_elems(self, coll_id: int) -> int:
        return int(self._t.out_log[self._out_cid(coll_id)])

    def in_elems(self, coll_id: int) -> int:
        return int(self._t.in_log[coll_id])

    def _in_map(self, coll_id: int):
        """Logical -> padded input positions as an int64 device tensor, or
        None when the padded span is the logical payload itself."""
        if coll_id not in self._in_maps:
            m = self._t.stage_in_map[coll_id]
            span = int(self._t.in_span[coll_id])
            ident = m.size == span and bool((m == np.arange(span)).all())
            self._in_maps[coll_id] = None if ident else torch.as_tensor(
                m, dtype=torch.int64, device=self._ranks.device)
        return self._in_maps[coll_id]

    def _out_idx(self, coll_id: int) -> torch.Tensor:
        """Heap positions of the logical output (its chain tail's), int64."""
        tcid = self._out_cid(coll_id)
        if tcid not in self._out_maps:
            self._out_maps[tcid] = torch.as_tensor(
                self._specs[tcid].out_off
                + self._t.stage_out_map[tcid].astype(np.int64),
                dtype=torch.int64, device=self._ranks.device)
        return self._out_maps[tcid]

    # -- step boundary -----------------------------------------------------
    def step_prologue(self, st: DaemonState, ticks=()) -> DaemonState:
        """Open a step: clear the SQ/CQ (every cursor and entry — the
        in-step ``pack_sq``) and run the daemon launch prologue.  ONCE per
        step.  ``ticks``: the tick sizes the step will call; their graphs
        are captured here on the card, before any backward pass."""
        self._check_current()
        st = st._replace(
            sq_coll=torch.full_like(st.sq_coll, -1),
            sq_prio=torch.zeros_like(st.sq_prio),
            sq_in=torch.full_like(st.sq_in, -1),
            sq_out=torch.full_like(st.sq_out, -1),
            sq_size=torch.zeros_like(st.sq_size),
            sq_read=torch.zeros_like(st.sq_read),
            cq_coll=torch.full_like(st.cq_coll, -1),
            cq_count=torch.zeros_like(st.cq_count),
        )
        st = launch_prologue(st)
        for k in ticks:
            self._ticker.capture(st, int(k))
        return st

    # -- submission --------------------------------------------------------
    def submit(self, st: DaemonState, rank: int, coll_id: int,
               data: torch.Tensor, prio: int = 0) -> DaemonState:
        """Stage ``data`` ([in_log[coll_id]]) into rank's padded input span
        (in place) and append one SQE (registered buffer offsets; chain
        submissions are routed to the rank's entry stage exactly like the
        host path).  ``rank``/``coll_id``/``prio`` are ints."""
        lo = self._specs[coll_id].in_off
        span = int(self._t.in_span[coll_id])
        dst = st.heap_in[rank, lo:lo + span]
        vals = data.reshape(-1).to(device=dst.device, dtype=dst.dtype)
        m = self._in_map(coll_id)
        if m is None:
            dst.copy_(vals)
        else:
            dst.zero_()
            dst.index_copy_(0, m, vals)
        entry = self._entry_of.get(coll_id, {}).get(rank, coll_id)
        idx = st.sq_size[rank]
        ok = idx < self.cfg.sq_len
        on_rank = self._ranks == rank
        sel = (on_rank[:, None] & (self._slots == idx.clamp(
            max=self.cfg.sq_len - 1))[None, :] & ok)
        put = lambda a, v: torch.where(sel, v, a)
        return st._replace(
            sq_coll=put(st.sq_coll, entry),
            sq_prio=put(st.sq_prio, prio),
            sq_in=put(st.sq_in, -1),
            sq_out=put(st.sq_out, -1),
            sq_size=st.sq_size + (on_rank & ok).to(torch.int32),
        )

    def submit_all(self, st: DaemonState, coll_id: int, data: torch.Tensor,
                   prio: int = 0) -> DaemonState:
        """``data`` is [R, in_log[coll_id]]; one submit per member rank."""
        for r in self._specs[coll_id].comm.members:
            st = self.submit(st, r, coll_id, data[r], prio=prio)
        return st

    # -- results -----------------------------------------------------------
    def read(self, st: DaemonState, rank: int, coll_id: int) -> torch.Tensor:
        """Rank's logical output ([out_log], heap dtype); composite ids read
        their chain tail's region."""
        return st.heap_out[rank, self._out_idx(coll_id)]

    def read_all(self, st: DaemonState, coll_id: int) -> torch.Tensor:
        return st.heap_out[:, self._out_idx(coll_id)]

    def completed(self, st: DaemonState, coll_id: int) -> torch.Tensor:
        """[R] cumulative logical completions of ``coll_id`` (its chain
        tail)."""
        return st.completed[:, self._out_cid(coll_id)]

    # -- progress ----------------------------------------------------------
    def _relaunch_if_stalled(self, st: DaemonState) -> DaemonState:
        """Mid-step event-driven restart: when the fabric went not-live
        (drain/quit/budget) but work is pending, run the launch prologue —
        and ONLY the prologue; SQ cursors must survive.  A device-side
        select: no host read."""
        need = ~st.global_live[0] & ~_drained(st).all()
        return _gate(need.expand_as(st.global_live), launch_prologue(st), st)

    def tick(self, st: DaemonState, k: int,
             barrier: bool = False) -> tuple[DaemonState, TickFlags]:
        """Advance up to ``k`` supersteps (auto-relaunching first if the
        previous tick ended the launch with work still pending).
        ``barrier`` is the accounting tag: True when the caller blocks on
        this tick, False when it hides behind compute."""
        st = self._relaunch_if_stalled(st)
        return self._ticker.tick(st, int(k), barrier)

    def tick_until(self, st: DaemonState, done_fn: Callable, chunk: int = 8,
                   max_iters: int = 1024,
                   barrier: bool = False) -> DaemonState:
        """Tick in ``chunk``-superstep slices until ``done_fn(state)`` (a
        [] bool tensor) holds or ``max_iters`` slices elapse (bounded so a
        missing peer submission cannot hang the step).  One host read of
        ``done_fn`` per slice."""
        for _ in range(max_iters):
            if bool(done_fn(st)):
                break
            st, _ = self.tick(st, chunk, barrier=barrier)
        return st

    def drain(self, st: DaemonState, chunk: int = 16,
              max_iters: int = 1024) -> DaemonState:
        """Barrier-tick until every rank's submitted work completed — the
        step's only EXPOSED communication when overlap worked."""
        return self.tick_until(st, lambda s: _drained(s).all(), chunk=chunk,
                               max_iters=max_iters, barrier=True)
