"""OcclRuntime: the public host API of the deadlock-free collective library.

PyTorch port of the sim path of ``repro.core.runtime``.  The integration
contract is the paper's (Sec. 4): register communicators and collectives
once, then ``submit`` from any rank in ANY order with an optional
completion callback; ``drive`` launches the daemon event-driven and every
submitted collective completes (assuming every member rank eventually
submits it).

All R ranks live on one device behind a leading rank axis (the sim
backend).  ``OcclRuntime(cfg)`` runs on ``cuda`` and raises when no card is
present; tests pass ``device="cpu"``, which runs the same code with the
kernel's plain PyTorch version.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md, "Modules
to port"): composite algorithms and ``algo="auto"`` (item 4), ``evict``
(item 6), ``tick_fn`` / ``device_api`` (item 7) and the mesh backend
(item 11).
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Optional, Sequence

import numpy as np

from .algos import select_algo
from .config import OcclConfig, ReduceOp
from .daemon import build_sim_daemon
from .errors import ConnDepthWarning, DeadlockTimeout, RegistrationClosed
from .handles import CollectiveHandle
from .primitives import (
    CollKind,
    CollectiveSpec,
    Communicator,
    derive_slicing,
    io_chunked,
)
from . import recorder as _recorder
from .sqcq import SQE, HostQueues
from .staging import StagingEngine
from .state import DaemonState, init_state, resolve_device
from .tables import StaticTables, build_tables


class OcclRuntime:
    def __init__(self, cfg: OcclConfig, device=None):
        """``device``: where the daemon state lives — ``None`` means
        ``cuda`` (raises without a card); ``"cpu"`` runs the plain path."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.comms: list[Communicator] = []
        self.specs: list[CollectiveSpec] = []
        # Separate allocation arenas for input and output buffers: in_off
        # indexes heap_in and out_off indexes heap_out.
        self._in_ptr = 0
        self._out_ptr = 0
        self._tables: Optional[StaticTables] = None
        self._staging: Optional[StagingEngine] = None
        self._daemon = None
        self._state: Optional[DaemonState] = None
        self.queues = HostQueues(cfg)
        self.launches = 0
        # Per-launch bookkeeping (bounded window; aggregates live in the
        # device counters).
        self.launch_history: collections.deque = collections.deque(
            maxlen=1024)
        # Registration index -> collective id (CollectiveHandle resolves
        # through it), and the outstanding submissions per (rank, coll)
        # that collective_stats() reports.
        self._log_cids: list[int] = []
        self._outstanding: collections.Counter = collections.Counter()

    # ------------------------------------------------------------------
    # registration (paper Sec. 3.1.1)
    # ------------------------------------------------------------------
    def communicator(self, members: Sequence[int]) -> Communicator:
        if self._tables is not None:
            raise RegistrationClosed("register communicators before first launch")
        comm = Communicator(
            comm_id=len(self.comms), members=tuple(members),
            lane=len(self.comms))
        assert comm.lane < self.cfg.max_comms, "raise cfg.max_comms"
        self.comms.append(comm)
        return comm

    def _alloc_in(self, elems: int) -> int:
        off = self._in_ptr
        self._in_ptr += elems
        assert self._in_ptr <= self.cfg.heap_elems, "raise cfg.heap_elems"
        return off

    def _alloc_out(self, elems: int) -> int:
        off = self._out_ptr
        self._out_ptr += elems
        assert self._out_ptr <= self.cfg.heap_elems, "raise cfg.heap_elems"
        return off

    def register(self, kind: CollKind, comm: Communicator, n_elems: int,
                 op: ReduceOp = ReduceOp.SUM, root: int = 0,
                 algo: Optional[str] = None,
                 hierarchy: Optional[tuple] = None,
                 inherit_prio: bool = True,
                 chunk_sizes: Optional[Sequence[int]] = None
                 ) -> CollectiveHandle:
        """Register a collective; returns its :class:`CollectiveHandle`
        (an ``int`` subclass).  Only ``algo="ring"`` (the flat
        single-communicator ring) is ported; ``chunk_sizes`` gives the
        per-distance live counts of an ALL_TO_ALL_RAGGED."""
        if self._tables is not None:
            raise RegistrationClosed("register collectives before first launch")
        if chunk_sizes is not None and CollKind(kind) is not \
                CollKind.ALL_TO_ALL_RAGGED:
            raise ValueError(
                f"chunk_sizes is only meaningful for ALL_TO_ALL_RAGGED, "
                f"got kind={CollKind(kind)!r}")
        select_algo(self.cfg.algo if algo is None else algo, kind, n_elems,
                    len(comm.members), hierarchy=hierarchy, cfg=self.cfg)
        cid = self._register_ring(kind, comm, n_elems, op, root,
                                  chunk_sizes=chunk_sizes or ())
        reg_index = len(self._log_cids)
        self._log_cids.append(cid)
        return CollectiveHandle(cid, self, reg_index)

    def _register_ring(self, kind: CollKind, comm: Communicator,
                       n_elems: int, op: ReduceOp = ReduceOp.SUM,
                       root: int = 0,
                       chunk_sizes: Sequence[int] = ()) -> int:
        cid = len(self.specs)
        assert cid < self.cfg.max_colls, "raise cfg.max_colls"
        ns, rounds = derive_slicing(
            n_elems, comm.size, self.cfg.slice_elems, self.cfg.conn_depth)
        chunk = rounds * ns * self.cfg.slice_elems
        padded = comm.size * chunk
        if (CollKind(kind) is CollKind.ALL_TO_ALL
                and n_elems % comm.size != 0):
            raise ValueError(
                f"ALL_TO_ALL needs n_elems divisible by the ring size "
                f"(n_elems={n_elems}, ring={comm.size}); register "
                f"ALL_TO_ALL_RAGGED with per-distance chunk_sizes for "
                f"uneven payloads")
        inc, outc = io_chunked(kind)
        in_off = self._alloc_in(padded if inc else chunk)
        out_off = self._alloc_out(padded if outc else chunk)
        if chunk_sizes:
            cl = -(-n_elems // comm.size)
            sizes = tuple(int(z) for z in chunk_sizes)
            if (len(sizes) != comm.size
                    or any(z < 0 or z > cl for z in sizes)
                    or sum(sizes) < 1):
                raise ValueError(
                    f"chunk_sizes must be {comm.size} per-distance counts "
                    f"in [0, {cl}] (chunk capacity for n_elems={n_elems}) "
                    f"with at least one live element, got {sizes}")
        spec = CollectiveSpec(
            coll_id=cid, kind=kind, comm=comm, n_elems=n_elems, op=int(op),
            root=root, in_off=in_off, out_off=out_off, n_slices=ns,
            n_rounds=rounds, chunk_sizes=tuple(int(z) for z in chunk_sizes))
        self.specs.append(spec)
        return cid

    # ------------------------------------------------------------------
    # lazy build (first launch closes registration)
    # ------------------------------------------------------------------
    def _ensure_built(self):
        if self._tables is None:
            if (self.cfg.burst_slices > 1
                    and self.cfg.conn_depth < 3 * self.cfg.burst_slices):
                warnings.warn(
                    f"conn_depth={self.cfg.conn_depth} < 3 * burst_slices="
                    f"{3 * self.cfg.burst_slices}: the connector cannot "
                    "cover the burst credit round trip, so sustained "
                    "throughput relaxes to the 1-slice/superstep "
                    "equilibrium (no faster than burst_slices=1).  Set "
                    "conn_depth >= 3 * burst_slices or auto_conn_depth=True.",
                    ConnDepthWarning, stacklevel=3)
            self._tables = build_tables(self.cfg, self.comms, self.specs)
            self._daemon = build_sim_daemon(self.cfg, self._tables,
                                            self.device)
            self._staging = StagingEngine(self.cfg, self._tables)
            self._state = init_state(self.cfg, self.device)

    @property
    def state(self) -> DaemonState:
        self._ensure_built()
        return self._state

    def tick_fn(self, barrier: bool = True) -> Callable:
        raise NotImplementedError(
            "tick_fn is not ported yet (ROADMAP.md, 'Modules to port', "
            "item 7: in-step tick + device API)")

    def device_api(self):
        raise NotImplementedError(
            "device_api is not ported yet (ROADMAP.md, 'Modules to port', "
            "item 7: in-step tick + device API)")

    def evict(self, rank: int, relaunch: bool = True) -> dict:
        raise NotImplementedError(
            "evict is not ported yet (ROADMAP.md, 'Modules to port', "
            "item 6: flight recorder, diagnosis, elastic shrink)")

    # ------------------------------------------------------------------
    # data movement (send/recv buffers live in the per-rank heap)
    # ------------------------------------------------------------------
    def _spec(self, coll_id: int) -> CollectiveSpec:
        return self.specs[coll_id]

    def _current_cid(self, reg_index: int) -> int:
        """Registration index -> collective id (CollectiveHandle)."""
        return self._log_cids[reg_index]

    def _resolve_cid(self, coll_id) -> int:
        if isinstance(coll_id, CollectiveHandle) and \
                coll_id._runtime is self:
            return self._current_cid(coll_id.reg_index)
        return int(coll_id)

    def _resolve_off(self, coll_id: int, off: Optional[int], default: int,
                     span: int, name: str) -> int:
        """Default (None / -1 sentinel) or bounds-checked per-SQE override
        base offset."""
        if off is None or off == -1:
            return default
        if off < 0 or off + span > self.cfg.heap_elems:
            raise ValueError(
                f"collective {coll_id}: {name} override {off} + padded "
                f"span {span} outside [0, heap_elems={self.cfg.heap_elems})")
        return off

    def _resolve_in_off(self, coll_id: int, off: Optional[int]) -> int:
        return self._resolve_off(coll_id, off, self._spec(coll_id).in_off,
                                 int(self._tables.in_span[coll_id]),
                                 "in_off")

    def _resolve_out_off(self, coll_id: int, off: Optional[int]) -> int:
        return self._resolve_off(coll_id, off, self._spec(coll_id).out_off,
                                 int(self._tables.out_span[coll_id]),
                                 "out_off")

    def write_input(self, rank: int, coll_id: int, data: np.ndarray,
                    in_off: Optional[int] = None) -> None:
        """Place logical input data into the rank's heap (padded layout,
        pad positions zero-filled).  Supersedes any payload staged at the
        same buffer by an earlier ``submit(..., data=...)``."""
        self._ensure_built()
        coll_id = self._resolve_cid(coll_id)
        off = self._resolve_in_off(coll_id, in_off)
        self.queues.staged.pop((rank, coll_id, off), None)
        self._state = self._staging.write(
            self._state, [(rank, coll_id, data, off)])

    def write_inputs_bulk(self, writes: dict) -> None:
        """Batch heap writes ``{(rank, coll_id): data}`` (or ``data`` given
        as an ``(ndarray, in_off)`` pair to override the offset) in ONE
        host-to-device copy."""
        self._ensure_built()
        staged = self.queues.staged
        items = []
        for (rank, coll_id), v in writes.items():
            coll_id = self._resolve_cid(coll_id)
            if (isinstance(v, tuple) and len(v) == 2
                    and isinstance(v[0], np.ndarray)
                    and isinstance(v[1], (int, np.integer))):
                data, off = v[0], self._resolve_in_off(coll_id, v[1])
            else:
                data, off = v, self.specs[coll_id].in_off
            staged.pop((rank, coll_id, off), None)
            items.append((rank, coll_id, data, off))
        self._state = self._staging.write(self._state, items)

    def read_outputs_bulk(self, reads: list) -> dict:
        """Batch heap reads ``[(rank, coll_id), ...]`` (or ``(rank,
        coll_id, out_off)``) with ONE device-to-host copy.  Returns
        ``{(rank, coll_id): logical output}`` as owned arrays."""
        self._ensure_built()
        resolved: dict = {}
        orig_of: dict = {}
        for e in reads:
            cid = self._resolve_cid(e[1])
            off = (self._resolve_out_off(cid, e[2]) if len(e) > 2
                   else self.specs[cid].out_off)
            prev = resolved.setdefault((e[0], cid), off)
            if prev != off:
                raise ValueError(
                    f"conflicting out_off reads for (rank={e[0]}, "
                    f"coll={e[1]}): {prev} vs {off}; read each "
                    "dynamic-offset result with its own read_output call")
            orig_of.setdefault((e[0], cid), []).append((e[0], e[1]))
        keys = [(r, c, off) for (r, c), off in resolved.items()]
        got = self._staging.read(self._state, keys)
        out: dict = {}
        for (r, cid), v in got.items():
            for i, okey in enumerate(dict.fromkeys(orig_of[(r, cid)])):
                out[okey] = v if i == 0 else v.copy()
        return out

    def read_output(self, rank: int, coll_id: int,
                    out_off: Optional[int] = None) -> np.ndarray:
        """Gather logical output data from the rank's heap (un-pad);
        returns an owned copy."""
        self._ensure_built()
        coll_id = self._resolve_cid(coll_id)
        return self._staging.read(
            self._state,
            [(rank, coll_id, self._resolve_out_off(coll_id, out_off))]
        )[(rank, coll_id)]

    # ------------------------------------------------------------------
    # submission + event-driven execution (paper Sec. 3.1.2 / 3.1.3)
    # ------------------------------------------------------------------
    def submit(self, rank: int, coll_id: int, prio: int = 0,
               data: Optional[np.ndarray] = None,
               callback: Optional[Callable[[int, int], None]] = None,
               in_off: int = -1, out_off: int = -1) -> None:
        """Enqueue one SQE.  A payload passed via ``data`` is STAGED
        host-side and flushed to the device in the next launch prologue
        (one batched copy per launch).  ``in_off``/``out_off`` override the
        registered heap offsets for this submission (-1 keeps them)."""
        self._ensure_built()
        coll_id = self._resolve_cid(coll_id)
        in_off = self._resolve_in_off(coll_id, in_off)
        out_off = self._resolve_out_off(coll_id, out_off)
        if data is not None:
            self.queues.stage(rank, coll_id,
                              self._staging.snapshot(coll_id, data), in_off)
        key = (rank, coll_id)
        self._outstanding[key] += 1

        def _acct(r, c, _key=key, _user=callback):
            self._outstanding[_key] -= 1
            if _user is not None:
                _user(r, c)

        self.queues.submit(rank, SQE(coll_id=coll_id, prio=prio,
                                     in_off=in_off, out_off=out_off,
                                     callback=_acct))

    def submit_all(self, coll_id: int, prio=0, data=None, callback=None,
                   in_off=-1, out_off=-1) -> None:
        """Submit one collective on every member rank; each argument is a
        single value for all ranks or a per-rank ``{rank: value}`` map."""
        coll_id = self._resolve_cid(coll_id)

        def pick(v, r, default):
            return v.get(r, default) if isinstance(v, dict) else v

        for r in self._spec(coll_id).comm.members:
            self.submit(r, coll_id,
                        prio=pick(prio, r, 0),
                        data=pick(data, r, None),
                        callback=pick(callback, r, None),
                        in_off=pick(in_off, r, -1),
                        out_off=pick(out_off, r, -1))

    def _flush_staged(self) -> None:
        """Launch prologue: drain the submit-time staging queue into the
        device heap — one batched copy for every payload submitted since
        the previous launch."""
        staged = self.queues.take_staged()
        if staged:
            self._state = self._staging.write(self._state, staged,
                                              owned=True)

    def launch_once(self) -> int:
        """One daemon launch; returns #CQEs drained (may be 0)."""
        self._ensure_built()
        self._flush_staged()
        prev_slices = int(self._state.slices_moved.sum())
        st = self.queues.pack_sq(self._state)
        st = self._daemon(st)
        self.launches += 1
        self._state = st
        fired = self.queues.reconcile(st)
        self.launch_history.append({
            "epoch": int(st.epoch.max()),
            "launch_steps": int(st.launch_steps.max()),
            "slices_moved": int(st.slices_moved.sum()) - prev_slices,
            "completions": fired,
        })
        return fired

    def drive(self, max_launches: int = 64) -> None:
        """Event-driven daemon restarting: run while #CQE < #SQE (Sec.
        3.1.3).  ``max_launches`` bounds CONSECUTIVE launches without
        progress (no completions and no slices moved)."""
        idle = 0
        while self.queues.outstanding() != 0:
            self.launch_once()
            rec = self.launch_history[-1]
            if rec["completions"] == 0 and rec["slices_moved"] == 0:
                idle += 1
            else:
                idle = 0
            if idle >= max_launches:
                raise self._deadlock_error(
                    f"{self.queues.outstanding()} collectives outstanding "
                    f"after {idle} consecutive daemon launches without "
                    f"progress ({self.launches} total) — a member rank "
                    f"never submitted a matching collective")

    def _deadlock_error(self, msg: str) -> DeadlockTimeout:
        """The :class:`DeadlockTimeout` with the flight-recorder export
        attached (the host-side diagnosis is not ported yet)."""
        return DeadlockTimeout(msg, flight_record=self.export_flight_record())

    # ------------------------------------------------------------------
    # observability (paper Fig. 9)
    # ------------------------------------------------------------------
    def export_flight_record(self) -> dict:
        """Numpy export of the on-device flight-recorder ring (+ wrap-proof
        per-kind counters); decode with :func:`repro_torch.core.recorder.
        events`."""
        self._ensure_built()
        return _recorder.export_record(self._state, self.cfg)

    def _host(self, name: str) -> np.ndarray:
        return getattr(self._state, name).cpu().numpy()

    def collective_stats(self, coll_id) -> dict:
        """Per-collective observability slice (the CollectiveHandle
        ``stats()`` surface)."""
        self._ensure_built()
        cid = self._resolve_cid(coll_id)
        col = [cid]
        rtc_ev = self._host("rtc_events")[:, col]
        rtc_lat = self._host("rtc_latency")[:, col]
        with np.errstate(divide="ignore", invalid="ignore"):
            rtc_mean = np.where(rtc_ev > 0, rtc_lat / np.maximum(rtc_ev, 1),
                                0.0)
        return {
            "coll_id": cid,
            "algo": "ring",
            "members": tuple(self._spec(cid).comm.members),
            "stages": col,
            "completed": self._host("completed")[:, col],
            "stage_completions": self._host("stage_completions")[:, col],
            "preempts": self._host("preempts")[:, col],
            "stall_slices": self._host("stall_slices")[:, col],
            "rtc_events": rtc_ev,
            "rtc_latency": rtc_lat,
            "rtc_mean_latency": rtc_mean,
            "outstanding": {
                r: n for (r, c), n in self._outstanding.items()
                if c == cid and n
            },
        }

    def stats(self) -> dict:
        self._ensure_built()
        h = self._host
        return {
            "preempts": h("preempts"),            # [R, C]
            "stall_slices": h("stall_slices"),    # [R, C] — burst slices
                                                  # denied by the credit gate
            "qlen_at_fetch": h("qlen_at_fetch"),
            "completed": h("completed"),          # logical completions
            "stage_completions": h("stage_completions"),
            "chains": {},
            "algos": {},
            "lane_caps": np.asarray(self._tables.lane_caps),
            "supersteps": h("supersteps"),        # cumulative epoch clock
            "launch_steps": h("launch_steps"),    # last launch only
            "epoch": h("epoch"),                  # device launch counter
            "slices_moved": h("slices_moved"),
            "tick_calls": h("tick_calls"),
            "overlap_supersteps": h("overlap_steps"),
            "barrier_supersteps": h("barrier_steps"),
            "rtc_latency": h("rtc_latency"),
            "rtc_events": h("rtc_events"),
            "cq_count": h("cq_count"),
            "burst_slices": self.cfg.burst_slices,
            "launches": self.launches,
            "launch_history": list(self.launch_history),
            "staging_flush_writes": self._staging.flush_writes,
            "staging_flush_bytes": self._staging.flush_bytes,
            "flight_recorder": _recorder.export_record(self._state,
                                                       self.cfg),
        }
