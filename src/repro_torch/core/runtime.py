"""OcclRuntime: the public host API of the deadlock-free collective library.

PyTorch port of ``repro.core.runtime``.  The integration contract is the
paper's (Sec. 4): register communicators and collectives once, then
``submit`` from any rank in ANY order with an optional completion
callback; ``drive`` launches the daemon event-driven and every submitted
collective completes (assuming every member rank eventually submits it).

By default all R ranks live on one device behind a leading rank axis (the
sim backend).  ``OcclRuntime(cfg)`` runs on ``cuda`` and raises when no card
is present; tests pass ``device="cpu"``, which runs the same code with the
kernels' plain PyTorch versions.  ``OcclRuntime(cfg, mesh=devices)`` is the
mesh backend: one device per rank (``mesh[r]`` holds rank r's state and
runs its scheduler), the fabric the reference's fused per-ring-group
exchange; on one card every entry is ``cuda``, on the CPU ``cpu``.

Registration accepts every algorithm the reference does: the flat
``"ring"``, the composite plans of :mod:`repro_torch.core.algos`
(``"two_level"``, ``"torus"``, ``"hybrid"``, ``"tree"`` and the two-level
``ALL_TO_ALL``) lowered into device-chained stages, and ``"auto"`` (the
cost model of :mod:`repro_torch.core.costmodel`).  A hang raises
:class:`DeadlockTimeout` with the flight-recorder export and a diagnosis
naming the holder, and :meth:`OcclRuntime.evict` shrinks the fabric by
one rank (drain, rebuild for R-1, replay).  The tick surface is ported:
``tick_fn``, ``launch_once(tick_k=...)`` / ``drive(tick_k=...)`` and the
in-step :meth:`OcclRuntime.device_api`, all on one superstep machine
(:class:`~repro_torch.core.daemon.SimTicker`, or
:class:`~repro_torch.core.daemon.MeshTicker` on a mesh).
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .algos import build_plan, default_hierarchy, select_algo
from .config import OcclConfig, ReduceOp
from .daemon import (MeshTicker, SimTicker, build_mesh_daemon,
                     build_sim_daemon, launch_prologue)
from .errors import (ConnDepthWarning, DeadlockTimeout, EvictionError,
                     RegistrationClosed)
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
from .state import DaemonState, init_state, resolve_device, resolve_mesh
from .tables import StaticTables, build_tables


class OcclRuntime:
    def __init__(self, cfg: OcclConfig, device=None, cost_model=None,
                 mesh=None, mesh_axis: str = "rank"):
        """``device``: where the daemon state lives — ``None`` means
        ``cuda`` (raises without a card); ``"cpu"`` runs the plain path.
        ``cost_model``: a costmodel.CostModel used by ``algo="auto"``
        registration; None loads the persisted calibration lazily
        (BENCH_torch_calibration.json / REPRO_TORCH_CALIBRATION).
        ``mesh``: a sequence of ``cfg.n_ranks`` devices — the mesh backend,
        rank r's state and scheduler on ``mesh[r]`` (a CUDA entry raises
        without a card; ``device`` must then be None).  ``mesh_axis`` is
        kept for the reference's signature."""
        self.cfg = cfg
        self.mesh = None
        self.mesh_axis = mesh_axis
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None:
                raise ValueError("pass either device= or mesh=, not both")
            self.mesh = resolve_mesh(mesh, cfg.n_ranks)
            self.device = self.mesh[0]
        self._cost_model = cost_model
        self.comms: list[Communicator] = []
        self.specs: list[CollectiveSpec] = []
        # Composite-collective bookkeeping: a logical collective registered
        # with a multi-stage algorithm is a CHAIN of specs; the returned id
        # is the HEAD (the logical input endpoint), `_tail_of` maps it to
        # the tail (the logical output endpoint read_output addresses) and
        # `_chain_of` to the full stage list (per-stage stats).  Derived
        # sub-communicators are cached by their partition signature so
        # multiple composite collectives over the same grid share lanes.
        self._tail_of: dict[int, int] = {}
        self._chain_of: dict[int, list[int]] = {}
        self._derived_comms: dict = {}
        # Partial-membership chains (tree / hybrid plans): a rank that is
        # not a member of every stage SUBMITS at its first participating
        # stage (`_entry_of[head][rank]`) and COMPLETES at its last
        # (`_rank_tail[head][rank]`) — the daemon's per-rank chain maps
        # (tables.chain_next / chain_tail_r) advance it stage-to-stage in
        # between.  `_logical_members` keeps the logical group of each
        # composite head (the head SPEC's comm is only stage 0's derived
        # sub-communicator); `_algo_of` records the lowered algorithm per
        # logical collective for stats()/auto observability.
        self._entry_of: dict[int, dict[int, int]] = {}
        self._rank_tail: dict[int, dict[int, int]] = {}
        self._logical_members: dict[int, tuple] = {}
        self._algo_of: dict[int, str] = {}
        # Separate allocation arenas for input and output buffers: in_off
        # indexes heap_in and out_off indexes heap_out — two DIFFERENT
        # arrays — so a shared pointer only interleaved dead holes into
        # both address spaces.  Independent pointers pack each heap's live
        # regions contiguously (the staging engine coalesces adjacent
        # regions into single stacked device ops) and double the usable
        # capacity per cfg.heap_elems.
        self._in_ptr = 0
        self._out_ptr = 0
        self._tables: Optional[StaticTables] = None
        self._staging: Optional[StagingEngine] = None
        self._daemon = None
        self._ticker = None             # SimTicker, or MeshTicker on a mesh
        self._device_api = None
        self._state: Optional[DaemonState] = None
        self.queues = HostQueues(cfg)
        self.launches = 0
        # Per-launch bookkeeping (relaunch observability): one record per
        # launch_once with the device epoch, the supersteps the launch ran,
        # the slices it moved and the completions it reconciled.  Bounded:
        # a long-lived runtime relaunches indefinitely, so only the most
        # recent window is kept (aggregates live in the device counters).
        self.launch_history: collections.deque = collections.deque(
            maxlen=1024)
        # --- elastic-shrink bookkeeping (evict(); handles.py) -----------
        # The registration LOG is the durable description of the topology:
        # an ordered replay script of communicator() and register() calls
        # (with their ORIGINAL arguments) that evict() re-executes against
        # the shrunk rank set.  `_log_cids` maps each register() call's
        # log index to its CURRENT head collective id (None once a shrink
        # dissolved it) — the indirection CollectiveHandle resolves
        # through, which is what lets handles survive re-registration.
        self._reg_log: list[dict] = []
        self._log_cids: list[Optional[int]] = []
        self._head_to_reg: dict[int, int] = {}
        self._replaying = False
        self._generation = 0        # bumped by evict(); staleness guard
        # Outstanding-submission ledger: submit() appends one record per
        # SQE (popped by an always-attached accounting callback when the
        # completion reconciles) so evict() can replay staged-but-
        # unlaunched work, and diagnose() can name the collective each
        # waiting rank is blocked on.  `_submit_counts` is cumulative —
        # the lagging-submitter signal of recorder.diagnose().
        self._outstanding: dict = collections.defaultdict(collections.deque)
        self._submit_counts: dict = {}
        self._sub_seq = 0
        self.evictions: list[int] = []  # evict() history (ranks as passed)

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
        if not self._replaying:
            # Log the creation ORDER (lane assignment is order-dependent)
            # so evict()'s replay reproduces the same lane layout.
            self._reg_log.append({"what": "comm", "comm_id": comm.comm_id,
                                  "members": comm.members})
        return comm

    def logical_communicator(self, members: Sequence[int]) -> Communicator:
        """A communicator DESCRIPTOR for composite registration: names the
        member grid without claiming a daemon lane.  Composite chains run
        entirely on their derived sub-communicator lanes, so a logical
        group that only ever registers multi-stage algorithms would waste
        a lane, stepped every superstep, on a ring no collective uses.
        Flat (``algo="ring"``) registration on it is rejected."""
        return Communicator(comm_id=-1, members=tuple(members), lane=-1)

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
        (paper Sec. 3.1.1).

        The handle IS the collective id (an ``int`` subclass, so every
        bare-``coll_id`` call path keeps working), owns the collective's
        operations (``submit``/``submit_all``/``write``/``read``/
        ``stats``) and — unlike a raw int — survives re-registration
        after an elastic shrink (``evict()``): it re-resolves through the
        registration log to its post-shrink id.

        ``algo`` selects the lowering (default ``cfg.algo``): ``"ring"``
        is the flat single-communicator ring; the composite plans
        (algos.PLAN_BUILDERS — ``"two_level"``/``"torus"``/``"hybrid"``
        for ALL_REDUCE, ``"tree"`` for BROADCAST/REDUCE) lower the
        collective over a ``G x N`` rank grid (``hierarchy``; the most
        square factorization when omitted) into a device-chained stage
        sequence; ``"auto"`` ranks the registered candidates with the
        measured α-β-γ cost model (core/costmodel.py — the calibration
        persisted in BENCH_torch_calibration.json, or the runtime's
        injected ``cost_model``).  For a chain the returned id is the logical
        handle: submit/stage payloads against it, read results from it
        (the runtime routes reads to the chain tail), and its CQ callback
        fires ONCE when the whole chain completes on the callback's rank.
        ``inherit_prio`` lets device-enqueued successor stages inherit the
        submission's live priority (the chain competes as one unit).

        ``chunk_sizes`` (ALL_TO_ALL_RAGGED only) gives the per-DISTANCE
        live element counts of the capacity-dropped exchange: member m's
        chunk s carries ``chunk_sizes[s]`` elements for member (m+s) mod
        R; the rest of each chunk's capacity is padding staged as zeros
        and never read back.  Logical I/O sizes become
        ``sum(chunk_sizes)`` on both sides.
        """
        head = self._register_impl(kind, comm, n_elems, op=op, root=root,
                                   algo=algo, hierarchy=hierarchy,
                                   inherit_prio=inherit_prio,
                                   chunk_sizes=chunk_sizes)
        reg_index = len(self._log_cids)
        self._reg_log.append({
            "what": "register", "reg_index": reg_index,
            "comm_id": comm.comm_id, "members": tuple(comm.members),
            "kind": kind, "n_elems": int(n_elems), "op": op,
            "root": int(root), "algo": algo,
            "hierarchy": tuple(hierarchy) if hierarchy is not None else None,
            "inherit_prio": bool(inherit_prio),
            "chunk_sizes": (tuple(int(z) for z in chunk_sizes)
                            if chunk_sizes is not None else None),
        })
        self._log_cids.append(head)
        self._head_to_reg[head] = reg_index
        return CollectiveHandle(head, self, reg_index)

    def _register_impl(self, kind: CollKind, comm: Communicator,
                       n_elems: int, op: ReduceOp = ReduceOp.SUM,
                       root: int = 0, algo: Optional[str] = None,
                       hierarchy: Optional[tuple] = None,
                       inherit_prio: bool = True,
                       chunk_sizes: Optional[Sequence[int]] = None) -> int:
        """The registration body (shared by register() and evict()'s
        replay); returns the raw head collective id."""
        if self._tables is not None:
            raise RegistrationClosed("register collectives before first launch")
        if chunk_sizes is not None and CollKind(kind) is not \
                CollKind.ALL_TO_ALL_RAGGED:
            raise ValueError(
                f"chunk_sizes is only meaningful for ALL_TO_ALL_RAGGED, "
                f"got kind={CollKind(kind)!r}")
        algo = select_algo(self.cfg.algo if algo is None else algo,
                           kind, n_elems, len(comm.members),
                           hierarchy=hierarchy, cfg=self.cfg,
                           model=self._cost_model)
        if algo == "ring":
            return self._register_ring(kind, comm, n_elems, op, root,
                                       chunk_sizes=chunk_sizes or ())
        if chunk_sizes is not None:
            raise ValueError(
                f"algo={algo!r} cannot lower a ragged all-to-all: "
                "per-distance sizes do not survive the composite granule "
                "transposes — register ALL_TO_ALL_RAGGED with algo='ring'")
        return self._register_composite(algo, kind, comm, n_elems, op,
                                        root, hierarchy, inherit_prio)

    def _register_ring(self, kind: CollKind, comm: Communicator,
                       n_elems: int, op: ReduceOp = ReduceOp.SUM,
                       root: int = 0, next_coll: int = -1,
                       chain_stage: int = 0,
                       inherit_prio: bool = True,
                       in_perm: Sequence[int] = (),
                       chunk_sizes: Sequence[int] = ()) -> int:
        cid = len(self.specs)
        assert cid < self.cfg.max_colls, "raise cfg.max_colls"
        if comm.lane < 0:
            raise ValueError(
                "flat (ring) registration needs a lane-bound communicator "
                "from runtime.communicator(); logical_communicator() "
                "descriptors only support composite algorithms")
        ns, rounds = derive_slicing(
            n_elems, comm.size, self.cfg.slice_elems, self.cfg.conn_depth)
        chunk = rounds * ns * self.cfg.slice_elems
        padded = comm.size * chunk
        if (CollKind(kind) is CollKind.ALL_TO_ALL
                and n_elems % comm.size != 0):
            # A personalized exchange needs one equal granule per pair:
            # with a ragged tail granule the input clips by DESTINATION
            # and the output by ORIGIN, so the two layouts cannot carry
            # the same elements (data would be silently truncated).
            raise ValueError(
                f"ALL_TO_ALL needs n_elems divisible by the ring size "
                f"(n_elems={n_elems}, ring={comm.size}); register "
                f"ALL_TO_ALL_RAGGED with per-distance chunk_sizes for "
                f"uneven payloads")
        inc, outc = io_chunked(kind)
        in_off = self._alloc_in(padded if inc else chunk)
        out_off = self._alloc_out(padded if outc else chunk)
        if chunk_sizes:
            # Loud registration-time validation: the ragged capacities
            # must tile the padded chunk layout exactly (one count per
            # ring member, each within the chunk's logical capacity,
            # at least one live element overall) — tables.py re-asserts,
            # but a user-facing misregistration should name the rule.
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
            n_rounds=rounds, next_coll=next_coll, chain_stage=chain_stage,
            inherit_prio=inherit_prio, in_perm=tuple(in_perm),
            chunk_sizes=tuple(int(z) for z in chunk_sizes))
        self.specs.append(spec)
        return cid

    def _register_composite(self, algo: str, kind: CollKind,
                            comm: Communicator, n_elems: int, op: ReduceOp,
                            root: int, hierarchy: Optional[tuple],
                            inherit_prio: bool) -> int:
        """Lower ``algo`` to its stage chain (algos.build_plan) and
        register the stages back-to-back with successor links.  Derived
        heap regions for the chain intermediates come from the same split
        in/out arenas as flat collectives; lane budgets are validated as
        each derived sub-communicator partition claims a lane, and each
        stage's ``derive_slicing`` enforces the per-round connector cap
        for the widest stage's ring.

        Tree/hybrid plans have PARTIAL-membership stages (leader-only
        rings): per-rank entry/tail maps are recorded here so submit()
        can route each rank's SQE to its first participating stage and
        key its completion on its last — on device, tables.chain_next /
        chain_tail_r advance each rank through exactly its own stages."""
        if comm.ring_size is not None and comm.ring_size != len(comm.members):
            raise ValueError(f"{algo} lowering expects a flat logical "
                             "communicator, not an already-partitioned one")
        hier = (tuple(hierarchy) if hierarchy is not None
                else default_hierarchy(len(comm.members)))
        plan = build_plan(algo, kind, comm.members, hier, n_elems, root)
        head = len(self.specs)
        n_stages = len(plan.stages)
        assert head + n_stages <= self.cfg.max_colls, (
            f"composite registration needs {n_stages} collective slots; "
            "raise cfg.max_colls")
        for k, stage in enumerate(plan.stages):
            sub = self._derived_communicator(stage.members, stage.ring_size)
            self._register_ring(
                stage.kind, sub, stage.n_elems, op=op, root=stage.root,
                next_coll=(head + k + 1 if k + 1 < n_stages else -1),
                chain_stage=k, inherit_prio=inherit_prio,
                in_perm=stage.in_perm)
        tail = head + n_stages - 1
        self._tail_of[head] = tail
        self._chain_of[head] = list(range(head, tail + 1))
        self._logical_members[head] = tuple(comm.members)
        self._algo_of[head] = algo
        entry: dict[int, int] = {}
        rtail: dict[int, int] = {}
        for r in comm.members:
            mine = [head + k for k, stage in enumerate(plan.stages)
                    if r in stage.members]
            assert mine, (f"{algo} plan leaves rank {r} out of every "
                          "stage — logical members must all participate")
            if mine[0] != head:
                entry[r] = mine[0]
            if mine[-1] != tail:
                rtail[r] = mine[-1]
        if entry:
            self._entry_of[head] = entry
        if rtail:
            self._rank_tail[head] = rtail
        return head

    def _derived_communicator(self, members, ring_size: int) -> Communicator:
        """Sub-communicator for one composite stage: ``members`` tiled into
        disjoint ``ring_size`` rings sharing ONE lane.  Cached by partition
        signature so composite collectives over the same grid share lanes
        (e.g. every two-level bucket of a grad sync uses the same intra
        and inter lanes)."""
        key = (tuple(members), int(ring_size))
        cached = self._derived_comms.get(key)
        if cached is not None:
            return cached
        lane = len(self.comms)
        if lane >= self.cfg.max_comms:
            raise ValueError(
                f"composite stage needs daemon lane {lane} but "
                f"cfg.max_comms={self.cfg.max_comms}; each derived "
                "sub-communicator partition occupies one lane — raise "
                "max_comms")
        comm = Communicator(comm_id=lane, members=tuple(members),
                            lane=lane, ring_size=int(ring_size))
        self.comms.append(comm)
        self._derived_comms[key] = comm
        return comm

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
            if self.mesh is None:
                self._ticker = SimTicker(self.cfg, self._tables, self.device)
                self._daemon = build_sim_daemon(self.cfg, self._ticker)
            else:
                self._ticker = MeshTicker(self.cfg, self._tables, self.mesh)
                self._daemon = build_mesh_daemon(self.cfg, self._ticker)
            self._staging = StagingEngine(self.cfg, self._tables)
            self._state = init_state(self.cfg, self.device,
                                     sharding=self.mesh)

    @property
    def state(self) -> DaemonState:
        """The daemon state, [R, ...]; on the mesh a gathered copy of every
        rank's leaves (the view the reference's sharded array gives)."""
        self._ensure_built()
        if self.mesh is not None:
            return self._state.gather()
        return self._state

    # ------------------------------------------------------------------
    # tick surface (compute-communication overlap; daemon.py docstring)
    # ------------------------------------------------------------------
    def tick_fn(self, barrier: bool = True) -> Callable:
        """``tick(state, k) -> (state, TickFlags)`` over the full [R, ...]
        state (on the mesh the runtime's ShardedState, ``rt._state``), on
        the runtime's superstep machine (its CUDA graphs included).
        ``barrier`` is the accounting tag (daemon.TickFlags).  Host-driven
        tick launches (``launch_once(tick_k=...)``) use the barrier
        variant; in-step overlap goes through :meth:`device_api`."""
        self._ensure_built()
        ticker = self._ticker
        return lambda st, k: ticker.tick(st, k, bool(barrier))

    def device_api(self):
        """The in-step submission/tick/read API bound to this runtime's
        registrations (sim backend; core/device_api.py)."""
        if self.mesh is not None:
            raise NotImplementedError(
                "device_api() is sim-backend only: in-step ticks thread one "
                "[R, ...] state through the step")
        if self._device_api is None:
            from .device_api import DeviceApi
            self._device_api = DeviceApi(self)
        return self._device_api

    def adopt_state(self, st: DaemonState) -> None:
        """Install a state produced by in-step ticks (device_api) as the
        runtime's current state, syncing the host completion snapshot so
        a later ``reconcile`` does not re-fire device-side completions."""
        self._ensure_built()
        self._state = st
        self.queues._completed_seen = st.completed.cpu().numpy().astype(
            np.int64)

    # ------------------------------------------------------------------
    # data movement (send/recv buffers live in the per-rank heap)
    # ------------------------------------------------------------------
    def _spec(self, coll_id: int) -> CollectiveSpec:
        return self.specs[coll_id]

    def _current_cid(self, reg_index: int) -> int:
        """Registration-log index -> CURRENT head collective id."""
        cid = self._log_cids[reg_index]
        if cid is None:
            raise EvictionError(
                f"registration {reg_index} did not survive the last "
                "shrink (its group dissolved or could not be rebuilt)")
        return cid

    def _resolve_cid(self, coll_id) -> int:
        """Public-API id resolution: a :class:`CollectiveHandle` follows
        the registration log across shrinks; a plain int is the thin
        DEPRECATED shim — accepted verbatim, valid only against the
        current registration generation."""
        if isinstance(coll_id, CollectiveHandle) and \
                coll_id._runtime is self:
            return self._current_cid(coll_id.reg_index)
        return int(coll_id)

    def _resolve_off(self, coll_id: int, off: Optional[int], default: int,
                     span: int, name: str) -> int:
        """Default (None / -1 sentinel) or per-SQE-override base offset;
        overrides are bounds-checked and negatives other than the -1
        sentinel are rejected (an underflowed offset silently landing on
        the registered default is the silent-ignore bug class this layer
        exists to close)."""
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

    def _out_cid(self, coll_id: int) -> int:
        """Logical OUTPUT endpoint: the chain tail for composite
        collectives, the collective itself otherwise."""
        return self._tail_of.get(coll_id, coll_id)

    def _resolve_out_off(self, coll_id: int, off: Optional[int]) -> int:
        # Offsets resolve against the chain TAIL — the logical output
        # endpoint a per-SQE override addresses (runtime + daemon agree:
        # fetch_sqe applies the override at chain_tail[c]).
        tcid = self._out_cid(coll_id)
        return self._resolve_off(coll_id, off, self._spec(tcid).out_off,
                                 int(self._tables.out_span[tcid]),
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
        """Batch heap writes: ``{(rank, coll_id): data}`` in ONE
        host->device transfer + one fused scatter.  To override the
        registered offset, pass the value as an ``(ndarray, in_off)``
        pair — the payload must be an ``np.ndarray`` in that form, so a
        plain tuple/list of numbers is always treated as data."""
        self._ensure_built()
        specs = self.specs
        staged = self.queues.staged
        items = []
        for (rank, coll_id), v in writes.items():
            coll_id = self._resolve_cid(coll_id)
            if (isinstance(v, tuple) and len(v) == 2
                    and isinstance(v[0], np.ndarray)
                    and isinstance(v[1], (int, np.integer))):
                data, off = v[0], self._resolve_in_off(coll_id, v[1])
            else:                       # registered default: pre-validated
                data, off = v, specs[coll_id].in_off
            if staged:
                staged.pop((rank, coll_id, off), None)
            items.append((rank, coll_id, data, off))
        self._state = self._staging.write(self._state, items)

    def read_outputs_bulk(self, reads: list) -> dict:
        """Batch heap reads: ``[(rank, coll_id), ...]`` (or ``(rank,
        coll_id, out_off)``) with ONE fused gather + device->host transfer.
        Returns ``{(rank, coll_id): logical output}`` as owned copies.
        Composite collectives read from their chain TAIL's output region
        but stay keyed by the logical (head) id the caller passed."""
        self._ensure_built()
        specs = self.specs
        # Identical repeats dedup (pre-PR dict semantics); only CONFLICTING
        # offsets for one (rank, coll_id) are ambiguous — the result dict
        # could hold just one of them — and must be rejected.
        resolved: dict = {}
        orig_of: dict = {}
        for e in reads:
            cid = self._resolve_cid(e[1])
            tcid = self._out_cid(cid)
            off = (self._resolve_out_off(cid, e[2]) if len(e) > 2
                   else specs[tcid].out_off)
            prev = resolved.setdefault((e[0], tcid), off)
            if prev != off:
                raise ValueError(
                    f"conflicting out_off reads for (rank={e[0]}, "
                    f"coll={e[1]}): {prev} vs {off}; read each "
                    "dynamic-offset result with its own read_output call")
            orig_of.setdefault((e[0], tcid), []).append((e[0], e[1]))
        keys = [(r, c, off) for (r, c), off in resolved.items()]
        got = self._staging.read(self._state, keys)
        out: dict = {}
        for (r, tcid), v in got.items():
            for i, okey in enumerate(dict.fromkeys(orig_of[(r, tcid)])):
                # Every result stays an OWNED array even when a head and
                # its tail were both requested (aliased reads get copies).
                out[okey] = v if i == 0 else v.copy()
        return out

    def read_output(self, rank: int, coll_id: int,
                    out_off: Optional[int] = None) -> np.ndarray:
        """Gather logical output data from the rank's heap (un-pad);
        returns an owned copy (callers may mutate it in place).  For a
        composite collective this reads the chain tail's output region —
        the logical endpoint of the chain."""
        self._ensure_built()
        coll_id = self._resolve_cid(coll_id)
        tcid = self._out_cid(coll_id)
        return self._staging.read(
            self._state,
            [(rank, tcid, self._resolve_out_off(coll_id, out_off))]
        )[(rank, tcid)]

    # ------------------------------------------------------------------
    # submission + event-driven execution (paper Sec. 3.1.2 / 3.1.3)
    # ------------------------------------------------------------------
    def submit(self, rank: int, coll_id: int, prio: int = 0,
               data: Optional[np.ndarray] = None,
               callback: Optional[Callable[[int, int], None]] = None,
               in_off: int = -1, out_off: int = -1) -> None:
        """Enqueue one SQE.  A payload passed via ``data`` is STAGED
        host-side and flushed to the device in the next ``launch_once``
        prologue (one batched transfer per launch), not written at call
        time.  ``in_off``/``out_off`` override the registered heap offsets
        for this submission (-1 keeps the defaults); the override is
        honored both by the daemon (SQE fetch) and by the staged write.

        For a composite (chained) collective the id is the logical
        handle: the payload stages into the chain HEAD's input region,
        ``out_off`` overrides the chain TAIL's output region, and the
        callback fires once — when this rank's last participating stage
        completes — with the logical id the caller submitted.  On a
        partial-membership chain (tree/hybrid plans) the SQE itself is
        routed to the rank's ENTRY stage: a rank skipping the head would
        otherwise fetch a stage it is not a member of and stall the
        chain forever."""
        self._ensure_built()
        in_off_arg, out_off_arg = in_off, out_off
        coll_id = self._resolve_cid(coll_id)
        in_off = self._resolve_in_off(coll_id, in_off)
        out_off = self._resolve_out_off(coll_id, out_off)
        if data is not None:
            # snapshot() validates and COPIES: the flush happens at the
            # next launch prologue, and the pre-PR immediate-write
            # semantics captured the value at call time — a caller
            # reusing its buffer between submit and drive must not leak
            # the mutation in.
            self.queues.stage(rank, coll_id,
                              self._staging.snapshot(coll_id, data), in_off)
        entry = self._entry_of.get(coll_id, {}).get(rank, coll_id)
        # This rank's completion endpoint (CQE source stage): its last
        # participating stage — the logical tail except on chains that
        # drop the rank early (e.g. tree-reduce non-leaders).
        tcid = self._rank_tail.get(coll_id, {}).get(
            rank, self._out_cid(coll_id))
        cb = callback
        if callback is not None and tcid != coll_id:
            # CQEs of a chain are emitted by the rank's tail stage;
            # surface the LOGICAL id to the user callback.
            def cb(r, _c, _cb=callback, _lc=coll_id):
                _cb(r, _lc)
        # Outstanding-submission ledger (evict() replay + diagnose()):
        # one record per SQE, popped by the accounting callback when the
        # completion reconciles.  Payloads are NOT duplicated here —
        # evict() recovers them from the staging queue or the device heap.
        key = (rank, coll_id)
        self._outstanding[key].append({
            "seq": self._sub_seq, "rank": rank, "cid": coll_id,
            "reg_index": self._head_to_reg.get(coll_id),
            "prio": prio, "callback": callback,
            "in_off_arg": in_off_arg, "out_off_arg": out_off_arg,
            "in_off": in_off, "out_off": out_off,
            "had_data": data is not None,
        })
        self._sub_seq += 1
        self._submit_counts[key] = self._submit_counts.get(key, 0) + 1

        def _acct(r, c, _key=key, _user=cb):
            dq = self._outstanding.get(_key)
            if dq:
                dq.popleft()
            if _user is not None:
                _user(r, c)

        # A non-head entry stage never reads the logical input (broadcast
        # non-roots), so the head-resolved in_off override must not leak
        # into its fetch — the entry keeps its registered default.
        sqe_in = in_off if entry == coll_id else -1
        self.queues.submit(rank, SQE(coll_id=entry, prio=prio,
                                     in_off=sqe_in, out_off=out_off,
                                     callback=_acct),
                           cb_coll=tcid)

    def submit_all(self, coll_id: int, prio=0, data=None, callback=None,
                   in_off=-1, out_off=-1) -> None:
        """Submit one collective on every member rank.

        Every argument is forwarded to :meth:`submit` and may be either a
        single value applied to all ranks or a per-rank ``{rank: value}``
        mapping (missing ranks take the default) — so a caller can hand
        per-rank priorities, payloads, completion callbacks and dynamic
        buffer offsets without falling back to a hand-rolled submit loop.
        """
        coll_id = self._resolve_cid(coll_id)
        members = self._logical_members.get(
            coll_id, self._spec(coll_id).comm.members)

        def pick(v, r, default):
            return v.get(r, default) if isinstance(v, dict) else v

        for r in members:
            self.submit(r, coll_id,
                        prio=pick(prio, r, 0),
                        data=pick(data, r, None),
                        callback=pick(callback, r, None),
                        in_off=pick(in_off, r, -1),
                        out_off=pick(out_off, r, -1))

    def _flush_staged(self) -> None:
        """Launch prologue: drain the submit-time staging queue into the
        device heap — one batched scatter for every payload submitted
        since the previous launch."""
        staged = self.queues.take_staged()
        if staged:
            self._state = self._staging.write(self._state, staged,
                                              owned=True)

    def launch_once(self, tick_k: Optional[int] = None) -> int:
        """One daemon launch; returns #CQEs drained (may be 0).

        ``tick_k`` switches to the host-driven TICK path: the launch is the
        prologue plus repeated ``tick(tick_k)`` calls until the fabric goes
        not-live, one host read of the live flag per call.  Batching
        invariance (daemon.py docstring) makes the trajectory bit-identical
        to the one-shot launch for any ``tick_k >= 1``."""
        self._ensure_built()
        self._flush_staged()
        prev_slices = int(self._state.slices_moved.sum())
        st = self.queues.pack_sq(self._state)
        if tick_k is None:
            st = self._daemon(st)
        else:
            tick = self.tick_fn(barrier=True)
            st = launch_prologue(st)
            while True:
                st, flags = tick(st, int(tick_k))
                if not bool(flags.live):
                    break
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

    def drive(self, max_launches: int = 64,
              tick_k: Optional[int] = None) -> None:
        """Event-driven daemon restarting: run while #CQE < #SQE (Sec.
        3.1.3).  ``max_launches`` bounds CONSECUTIVE launches without
        progress (no completions and no slices moved).  ``tick_k`` routes
        every launch through the host-driven tick path (see
        :meth:`launch_once`)."""
        idle = 0
        while self.queues.outstanding() != 0:
            self.launch_once(tick_k=tick_k)
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
        """Build the enriched :class:`DeadlockTimeout`: the flight-recorder
        export plus a host-side diagnosis naming the rank(s) holding each
        stalled collective ride on the exception."""
        export = self.export_flight_record()
        diag = None
        try:
            diag = _recorder.diagnose(self)
            if diag is not None and diag.stalled:
                msg = msg + "\n" + str(diag)
        except Exception:  # diagnosis is best-effort — never mask the hang
            pass
        return DeadlockTimeout(msg, flight_record=export, diagnosis=diag)

    # ------------------------------------------------------------------
    # elastic shrink (evict one rank, rebuild for R-1, replay, resume)
    # ------------------------------------------------------------------
    def _drain_completable(self, max_idle: int = 2,
                           max_total: int = 64) -> int:
        """Run the daemon until every COMPLETABLE in-flight chain has
        drained: launches repeat while they make progress (completions or
        slices moved) and stop after ``max_idle`` idle launches — work
        still outstanding then is wedged (typically on the rank about to
        be evicted) and becomes evict()'s replay set.  Never raises on
        the wedged remainder; returns the number of launches run."""
        n = idle = 0
        while self.queues.outstanding() and n < max_total and \
                idle < max_idle:
            self.launch_once()
            n += 1
            rec = self.launch_history[-1]
            if rec["completions"] == 0 and rec["slices_moved"] == 0:
                idle += 1
            else:
                idle = 0
        return n

    def evict(self, rank: int, relaunch: bool = True) -> dict:
        """Elastically shrink the fabric by one rank.

        Lifecycle (drain -> rebuild -> replay):

        1. **Drain**: run the daemon until every completable in-flight
           chain finishes; what remains outstanding is wedged (usually on
           the evicted rank).  Payloads of the wedged submissions are
           recovered host-side — from the submit-time staging queue if
           not yet flushed, else gathered straight out of the old device
           ``heap_in`` through the registration's logical index map.
        2. **Rebuild**: reset every derived structure (communicators,
           specs, chain tables, heap arenas, staging engine, daemon
           program, host queues, device state) and REPLAY the
           registration log against the shrunk rank set — surviving
           members renumber ``m -> m - (m > rank)``.  Each registration
           keeps its log index, so existing :class:`CollectiveHandle`\\ s
           re-resolve transparently; a registration whose group
           dissolves, whose root rank died (BROADCAST/REDUCE), or whose
           per-peer chunk layout cannot tile the smaller ring (flat and
           ragged ALL_TO_ALL) resolves to "gone" and its handle raises
           :class:`EvictionError` on use.  The rewritten log (members
           AND root) is renumbered post-shrink, so evictions compose.
        3. **Replay**: re-submit every surviving wedged submission in
           original submission order with its recovered payload and
           original arguments, then (``relaunch=True``) ``drive()`` once
           — the single relaunch after which the fabric runs normally.

        The rebuilt runtime is indistinguishable from a FRESH runtime
        constructed at R-1 with the same registration script: scheduler
        state starts clean, so post-evict supersteps and collective
        outputs are bit-identical to the fresh baseline.

        Caveats: device ``heap_out`` contents do not survive the rebuild
        — read results BEFORE evicting (completed-but-unread outputs are
        dropped); the evicted rank's own outstanding submissions die
        with it; registration stays closed (the log replays, new
        registrations are still rejected).  Sim backend only.

        On the card the old daemon's captured CUDA graph is dropped with
        the daemon (it reads the old heaps); the rebuilt daemon captures
        its own on its first full chunk, and the kernel launch counter
        counts replays only, so it stays exact across the re-capture.
        """
        if self.mesh is not None:
            raise NotImplementedError(
                "evict() is sim-backend only: shrinking a device mesh needs "
                "a new mesh over the surviving devices — rebuild the "
                "runtime on the shrunk mesh with the same registration "
                "script instead")
        R = self.cfg.n_ranks
        if not 0 <= rank < R:
            raise EvictionError(f"rank {rank} outside [0, {R})")
        if R <= 1:
            raise EvictionError("cannot shrink below 1 rank")
        self._ensure_built()
        # --- 1. drain ---------------------------------------------------
        drain_launches = self._drain_completable()
        old_state = self._state
        old_tables = self._tables
        old_staged = dict(self.queues.staged)
        records = sorted(
            (rec for dq in self._outstanding.values() for rec in dq),
            key=lambda d: d["seq"])
        replay = []
        dropped = []
        for rec in records:
            if rec["rank"] == rank:
                dropped.append(rec)
                continue
            if rec["reg_index"] is None:
                raise EvictionError(
                    f"outstanding submission of collective {rec['cid']} on "
                    f"rank {rec['rank']} was made against a raw non-head "
                    "stage id — it cannot be re-resolved after a shrink "
                    "(submit logical collective handles/ids only)")
            data = None
            n_log = int(old_tables.in_log[rec["cid"]])
            if n_log > 0:
                key = (rec["rank"], rec["cid"], rec["in_off"])
                if key in old_staged:
                    data = np.asarray(old_staged[key])
                else:
                    # Gathered on the device and widened to float32 (exact
                    # for every heap dtype); the replay's staging casts it
                    # back.
                    idx = torch.as_tensor(
                        rec["in_off"] + old_tables.stage_in_map[rec["cid"]],
                        dtype=torch.int64, device=self.device)
                    data = old_state.heap_in[rec["rank"], idx].float() \
                        .cpu().numpy()
            replay.append((rec, data))
        # --- 2. rebuild for R-1 -----------------------------------------
        dead = rank
        remap = {m: m - (m > dead) for m in range(R)}
        old_log = self._reg_log
        old_cids = list(self._log_cids)
        self.cfg = dataclasses.replace(self.cfg, n_ranks=R - 1)
        self.comms = []
        self.specs = []
        self._tail_of = {}
        self._chain_of = {}
        self._derived_comms = {}
        self._entry_of = {}
        self._rank_tail = {}
        self._logical_members = {}
        self._algo_of = {}
        self._in_ptr = 0
        self._out_ptr = 0
        self._tables = None
        self._staging = None
        self._daemon = None             # drops its captured CUDA graphs
        self._ticker = None
        self._device_api = None
        self._state = None
        self.queues = HostQueues(self.cfg)
        self._outstanding = collections.defaultdict(collections.deque)
        self._submit_counts = {}
        self._generation += 1
        self.evictions.append(rank)
        new_log: list[dict] = []
        new_log_cids: list[Optional[int]] = []
        self._head_to_reg = {}
        # The log's comm_id fields are SYMBOLIC join keys between comm and
        # register entries (stable across shrinks); the rebuilt
        # Communicator objects get fresh lane-ordered ids of their own.
        comm_map: dict = {}
        self._replaying = True
        try:
            for entry in old_log:
                members = tuple(remap[m] for m in entry["members"]
                                if m != dead)
                if entry["what"] == "comm":
                    new_log.append(dict(entry, members=members))
                    comm_map[entry["comm_id"]] = (
                        self.communicator(members) if members else None)
                    continue
                # register entry: keep its _log_cids POSITION even when it
                # dissolves — handle reg_index stability depends on it.
                reg_index = len(new_log_cids)
                was_alive = old_cids[reg_index] is not None
                rooted = CollKind(entry["kind"]) in (
                    CollKind.BROADCAST, CollKind.REDUCE)
                # The rewritten log is in POST-shrink numbering: the root
                # must be remapped alongside the members (a stale root
                # would be misread against the NEXT evict's dead rank /
                # remap).  A rooted entry whose root is gone keeps the
                # tombstone -1 so it stays dissolved across later evicts.
                root = entry["root"]
                root_gone = rooted and (root < 0 or root == dead)
                new_root = -1 if root_gone else \
                    (remap[root] if rooted else 0)
                new_entry = dict(entry, members=members, root=new_root)
                new_log.append(new_entry)
                head = None
                comm = None
                if members:
                    if entry["comm_id"] == -1:
                        comm = self.logical_communicator(members)
                    else:
                        comm = comm_map.get(entry["comm_id"])
                if comm is not None:
                    hier = entry["hierarchy"]
                    if hier is not None and \
                            int(np.prod(hier)) != len(members):
                        hier = None  # re-derive for the smaller group
                    sizes = entry["chunk_sizes"]
                    if sizes is not None and len(sizes) != len(members):
                        # Per-distance ragged capacities are defined over
                        # the ORIGINAL ring size; they cannot be remapped
                        # onto a smaller ring — dissolve loudly.
                        if was_alive:
                            warnings.warn(
                                f"registration {reg_index} "
                                "(ALL_TO_ALL_RAGGED) dissolved by evict(): "
                                f"chunk_sizes has {len(sizes)} per-distance "
                                f"counts but the shrunk group has "
                                f"{len(members)} members", stacklevel=2)
                        comm = None
                    elif CollKind(entry["kind"]) is CollKind.ALL_TO_ALL:
                        # The flat all-to-all's I/O is R equal per-peer
                        # chunks of n_elems/R: any payload (staged,
                        # in-heap, or application-side) laid out for the
                        # original ring scrambles on a smaller one (chunk
                        # size changes, the dead rank's chunk has no
                        # destination) — dissolve like the ragged variant.
                        if was_alive:
                            warnings.warn(
                                f"registration {reg_index} (ALL_TO_ALL) "
                                "dissolved by evict(): its per-peer chunk "
                                "layout is defined over the original ring "
                                "size and cannot be re-tiled for "
                                f"{len(members)} members", stacklevel=2)
                        comm = None
                    if comm is not None and root_gone:
                        # The semantic endpoint (broadcast source / reduce
                        # destination) is gone; silently re-rooting would
                        # change the collective's meaning.
                        if was_alive:
                            warnings.warn(
                                f"registration {reg_index} "
                                f"({CollKind(entry['kind']).name}) "
                                f"dissolved by evict(): its root rank "
                                f"{dead} was evicted", stacklevel=2)
                        comm = None
                    if comm is not None:
                        head = self._register_impl(
                            entry["kind"], comm, entry["n_elems"],
                            op=entry["op"],
                            root=(new_root if rooted else 0),
                            algo=entry["algo"], hierarchy=hier,
                            inherit_prio=entry["inherit_prio"],
                            chunk_sizes=sizes)
                        self._head_to_reg[head] = reg_index
                new_log_cids.append(head)
        finally:
            self._replaying = False
        self._reg_log = new_log
        self._log_cids = new_log_cids
        # --- 3. replay surviving wedged submissions ---------------------
        replayed = 0
        for rec, data in replay:
            new_cid = self._log_cids[rec["reg_index"]]
            if new_cid is None:
                warnings.warn(
                    f"dropping outstanding submission of dissolved "
                    f"registration {rec['reg_index']} on old rank "
                    f"{rec['rank']} (its completion callback will never "
                    "fire)", stacklevel=2)
                continue
            self.submit(remap[rec["rank"]], new_cid, prio=rec["prio"],
                        data=data, callback=rec["callback"],
                        in_off=rec["in_off_arg"],
                        out_off=rec["out_off_arg"])
            replayed += 1
        if relaunch and self.queues.outstanding():
            self.drive()
        return {
            "evicted_rank": rank,
            "n_ranks": self.cfg.n_ranks,
            "generation": self._generation,
            "drain_launches": drain_launches,
            "replayed": replayed,
            "dropped": len(dropped),
            "dissolved": [i for i, c in enumerate(self._log_cids)
                          if c is None],
        }

    # ------------------------------------------------------------------
    # observability (paper Fig. 9)
    # ------------------------------------------------------------------
    def export_flight_record(self) -> dict:
        """Numpy export of the on-device flight-recorder ring (+ wrap-proof
        per-kind counters); decode with
        :func:`repro_torch.core.recorder.events`.  Included in
        :meth:`stats` and attached to every :class:`DeadlockTimeout` this
        runtime raises."""
        self._ensure_built()
        return _recorder.export_record(self._state, self.cfg)

    def _host(self, name: str) -> np.ndarray:
        return getattr(self._state, name).cpu().numpy()

    def collective_stats(self, coll_id) -> dict:
        """Per-collective observability slice (the :class:`CollectiveHandle`
        ``stats()`` surface): the logical head's chain stages and the
        scheduler counters restricted to those stage columns."""
        self._ensure_built()
        cid = self._resolve_cid(coll_id)
        stages = list(self._chain_of.get(cid, [cid]))
        cols = np.asarray(stages, dtype=np.int64)
        h = self._host
        rtc_ev = h("rtc_events")[:, cols]
        rtc_lat = h("rtc_latency")[:, cols]
        with np.errstate(divide="ignore", invalid="ignore"):
            rtc_mean = np.where(rtc_ev > 0, rtc_lat / np.maximum(rtc_ev, 1),
                                0.0)
        return {
            "coll_id": cid,
            "algo": self._algo_of.get(cid, "ring"),
            "members": tuple(self._logical_members.get(
                cid, self._spec(cid).comm.members)),
            "stages": stages,                      # chain stage ids
            "completed": h("completed")[:, cols],                  # [R, S]
            "stage_completions": h("stage_completions")[:, cols],  # [R, S]
            "preempts": h("preempts")[:, cols],                    # [R, S]
            "stall_slices": h("stall_slices")[:, cols],            # [R, S]
            "rtc_events": rtc_ev,                                  # [R, S]
            "rtc_latency": rtc_lat,                                # [R, S]
            "rtc_mean_latency": rtc_mean,                          # [R, S]
            "outstanding": {
                r: len(dq) for (r, c), dq in self._outstanding.items()
                if c == cid and dq
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
            # Chain stage ids per logical composite head and the lowered
            # algorithm of each (flat registrations are implicitly "ring").
            "chains": dict(self._chain_of),
            "algos": dict(self._algo_of),
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
            # Writes that took the mesh's sharded placement (one row copy
            # per rank of a dense all-ranks block).
            "staging_sharded_flushes": self._staging.sharded_flushes,
            "flight_recorder": _recorder.export_record(self._state,
                                                       self.cfg),
        }
