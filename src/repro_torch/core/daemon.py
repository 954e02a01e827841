"""The daemon loop (paper Sec. 3.1): the sim and the mesh backends.

PyTorch port of ``repro.core.daemon``.  Both backends share the per-rank
scheduler core:

* **sim** — all ranks live on one device; per-rank state carries the leading
  rank axis written out, the scheduler superstep runs over all ranks at
  once, and the connector fabric is a gather along each lane's ring
  permutation.

* **mesh** — rank r's state lives on its own device ``mesh[r]`` (leaves
  with a leading axis of 1) and rank r's superstep runs there on its slice
  of the tables; the fabric is the reference's fused per-ring-group
  exchange (:func:`_mesh_exchange`): per lane group, ONE permute of the
  (coll, count) header ++ payload burst as i32 forward and ONE permute of
  the credit header back.  One controller issues every rank's work, as the
  reference's ``shard_map`` does (:class:`MeshTicker`).

The loop terminates on: all work drained, the voluntary-quit threshold
(consecutive fabric-wide no-progress supersteps, Sec. 3.1.3), or the hard
per-launch superstep budget; the host relaunches it event-driven while
completions lag submissions.

The loop without a host sync per superstep
------------------------------------------
The reference runs ``lax.while_loop`` until ``global_live`` is false.  Here
the host runs the loop body ``k`` times per check (``TICK_CHUNK`` for a
launch) and reads the live flag once per chunk.  Every body is GATED on the
device-side ``global_live`` it starts from: a body that runs after the
fabric went not-live changes no leaf of the state or the in-flight
mailbox (counters included) — its heap writes are masked and every other
leaf is selected back — so ``supersteps``, ``launch_steps`` and every
trajectory are bit-identical to the reference's, whatever ``k`` is (the
batching invariance of the reference's tick contract).  The same property
lets a launch on the card replay each full chunk as one CUDA graph
(:class:`_ChunkRunner`).  On the card a sim superstep is three kernels
(:func:`~repro_torch.kernels.superstep.fused_superstep`: select, the burst,
finish); the mesh's runs the scheduler's PyTorch ops, several hundred small
kernels per rank, which the graph keeps from bounding the daemon on the
host's launch rate.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import (QUEUE_KEY_DEMAND_STRIDE, QUEUE_KEY_PRIO_STRIDE,
                     OcclConfig, OrderPolicy)
from . import primitives as P
from . import recorder
from . import trace
from .scheduler import (
    LocalTables,
    Mailbox,
    SharedTables,
    chain_relink_fired,
    rank_superstep,
    rebase_arrivals,
)
from .state import DaemonState, ShardedState
from .tables import StaticTables
from ..kernels import fused_slice, superstep

# Supersteps a launch runs between two host reads of the live flag.
TICK_CHUNK = 16
# The kernel wrappers whose launches a chunk's replay adds.
_COUNTED = (fused_slice.fused_burst, superstep.fused_superstep)


def _dev(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.bool if a.dtype == np.bool_ else torch.int32
    return torch.as_tensor(a, dtype=dtype, device=device)


def shared_tables(t: StaticTables, device) -> SharedTables:
    return SharedTables(
        registered=_dev(t.registered, device),
        kind=_dev(t.kind, device),
        op=_dev(t.op, device),
        lane=_dev(t.lane, device),
        lane_caps=_dev(t.lane_caps, device),
        n_steps=_dev(t.n_steps, device),
        n_slices=_dev(t.n_slices, device),
        n_rounds=_dev(t.n_rounds, device),
        in_chunked=_dev(t.in_chunked, device),
        out_chunked=_dev(t.out_chunked, device),
        base_in_off=_dev(t.base_in_off, device),
        base_out_off=_dev(t.base_out_off, device),
        next_coll=_dev(t.next_coll, device),
        chain_tail=_dev(t.chain_tail, device),
        chain_prio_inherit=_dev(t.chain_prio_inherit, device),
        chain_mask=_dev(t.chain_mask, device),
        chain_src=_dev(t.chain_src, device),
        chain_dst=_dev(t.chain_dst, device),
        prim_recv=_dev(P.PRIM_RECV, device),
        prim_send=_dev(P.PRIM_SEND, device),
        prim_reduce=_dev(P.PRIM_REDUCE, device),
        prim_copy=_dev(P.PRIM_COPY, device),
        prim_reads_in=_dev(P.PRIM_READS_IN, device),
    )


def local_tables(t: StaticTables, device) -> LocalTables:
    """Per-rank tables with the leading rank axis."""
    return LocalTables(
        member=_dev(t.member, device),
        prog_kind=_dev(t.prog_kind, device),
        prog_chunk=_dev(t.prog_chunk, device),
        chain_next=_dev(t.chain_next, device),
        chain_tail_r=_dev(t.chain_tail_r, device),
    )


def _sim_exchange(fwd_src: torch.Tensor, rev_src: torch.Tensor,
                  outbox: Mailbox) -> Mailbox:
    """Deliver per-lane messages along each communicator ring.

    ``outbox`` fields have shape [R, L, ...]; the message arriving at rank
    r on lane l was sent by ``fwd_src[l, r]`` (resp. ``rev_src``): one
    batched gather over the (rank, lane) grid per field."""
    L = fwd_src.shape[0]
    lanes = torch.arange(L, device=fwd_src.device)[None, :]
    fs, rs = fwd_src.T, rev_src.T
    return Mailbox(
        fwd_count=outbox.fwd_count[fs, lanes],
        fwd_coll=outbox.fwd_coll[fs, lanes],
        fwd_payload=outbox.fwd_payload[fs, lanes],
        rev_count=outbox.rev_count[rs, lanes],
        rev_coll=outbox.rev_coll[rs, lanes],
    )


def _pack16_to_i32(pay: torch.Tensor, pad: int) -> torch.Tensor:
    """View PAIRS of adjacent 16-bit payload elements as i32 lanes.

    ``pay`` is [G, W] of a 2-byte dtype; an odd W is zero-padded by ``pad``
    (0 or 1) so every element has a pair partner.  Returns [G, (W+pad)//2]
    i32 — a pure bit view (no value is converted, so every bit pattern, a
    signalling NaN's included, rides the wire as it is), concatenable with
    the i32 (coll, count) header."""
    bits = pay.view(torch.int16)
    if pad:
        bits = torch.cat([bits, bits.new_zeros((bits.shape[0], pad))], 1)
    return bits.view(torch.int32)


def _unpack16_from_i32(packed: torch.Tensor, dtype: torch.dtype,
                       width: int) -> torch.Tensor:
    """Inverse of :func:`_pack16_to_i32`: [G, P] i32 -> [G, width] 16-bit
    (the pad element, if any, is sliced off)."""
    return packed.view(torch.int16)[:, :width].view(dtype)


def _ppermute(bufs: list, pairs) -> list:
    """One logical ``ppermute`` over the mesh: for each ``(src, dst)`` pair
    one copy of rank src's send buffer into rank dst's receive buffer; a
    rank no pair sends to receives zeros (the reference's semantics).

    A copy between two devices is a peer-to-peer copy that PyTorch orders
    after the sender's current stream and before the receiver's (it records
    an event on the one and makes the other wait on it; no host sync).  On
    one device the receive buffer is the send buffer itself: nothing writes
    either afterwards.  Counted in ``_ppermute.calls``."""
    _ppermute.calls += 1
    out = [None] * len(bufs)
    for src, dst in pairs:
        out[dst] = bufs[src].to(bufs[dst].device)
    return [torch.zeros_like(b) if o is None else o
            for b, o in zip(bufs, out)]


_ppermute.calls = 0


def _exchange_plan(t: StaticTables, devices) -> list:
    """Per lane group, each rank's lane-index tensor on that rank's device
    (built with the daemon: a captured body may copy nothing from the
    host)."""
    by_dev: dict = {}
    plan = []
    for lanes, _, _ in t.lane_groups:
        idx = []
        for d in devices:
            key = (tuple(lanes), torch.device(d))
            if key not in by_dev:
                by_dev[key] = torch.as_tensor(lanes, dtype=torch.int64,
                                              device=d)
            idx.append(by_dev[key])
        plan.append(idx)
    return plan


def _mesh_exchange(t: StaticTables, outboxes: list, plan=None) -> list:
    """Deliver messages over the mesh fabric: ``outboxes[r]`` is rank r's
    Mailbox (leaves [1, L, ...] on its device); returns the inboxes.

    Lanes whose communicators share a ring permutation are FUSED: their
    stacked traffic rides ONE permute per direction — forward, the (coll,
    count) headers and the [B, SL] payload bursts of every lane of the
    group in a single i32 buffer (a bit view for 32-bit heap dtypes; for
    16-bit dtypes adjacent payload-element PAIRS viewed as i32 lanes per the
    registration-time ``lane_group_pack16`` metadata, an odd row
    zero-padded); back, one i32 credit-header permute.  With one ring that
    is two permutes per superstep for 32-bit and 16-bit heaps alike; tables
    built with ``cfg.packed_16bit=False`` send a 16-bit payload in a permute
    of its own (three).  Lanes of no group receive zeros."""
    ob0 = outboxes[0]
    _, L, B, SL = ob0.fwd_payload.shape
    dt = ob0.fwd_payload.dtype
    wide = dt.itemsize == 4
    pack16 = t.lane_group_pack16 if dt.itemsize == 2 else None
    if plan is None:
        plan = _exchange_plan(t, [ob.fwd_count.device for ob in outboxes])
    got = [{f: torch.zeros_like(getattr(ob, f)) for f in Mailbox._fields}
           for ob in outboxes]
    for gi, (lanes, fwd_pairs, rev_pairs) in enumerate(t.lane_groups):
        G, idx = len(lanes), plan[gi]
        hdr = [torch.stack([ob.fwd_coll[0, g], ob.fwd_count[0, g]], 1)
               for ob, g in zip(outboxes, idx)]
        pay = [ob.fwd_payload[0, g].reshape(G, B * SL)
               for ob, g in zip(outboxes, idx)]
        if wide:
            moved = _ppermute([torch.cat([h, p.view(torch.int32)], 1)
                               for h, p in zip(hdr, pay)], fwd_pairs)
            got_hdr = [m[:, :2] for m in moved]
            got_pay = [m[:, 2:].view(dt) for m in moved]
        elif pack16 is not None:
            cols, pad = pack16[gi]
            moved = _ppermute([torch.cat([h, _pack16_to_i32(p, pad)], 1)
                               for h, p in zip(hdr, pay)], fwd_pairs)
            got_hdr = [m[:, :2] for m in moved]
            got_pay = [_unpack16_from_i32(m[:, 2:2 + cols], dt, B * SL)
                       for m in moved]
        else:
            got_hdr = _ppermute(hdr, fwd_pairs)
            got_pay = _ppermute(pay, fwd_pairs)
        rgot = _ppermute([torch.stack([ob.rev_coll[0, g], ob.rev_count[0, g]],
                                      1) for ob, g in zip(outboxes, idx)],
                         rev_pairs)
        for r, g in enumerate(idx):
            mb = got[r]
            mb["fwd_coll"][0, g] = got_hdr[r][:, 0]
            mb["fwd_count"][0, g] = got_hdr[r][:, 1]
            mb["fwd_payload"][0, g] = got_pay[r].reshape(G, B, SL)
            mb["rev_coll"][0, g] = rgot[r][:, 0]
            mb["rev_count"][0, g] = rgot[r][:, 1]
    return [Mailbox(**mb) for mb in got]


def count_exchange_ppermutes(cfg: OcclConfig, n_comms: int = 1) -> int:
    """Drive one :func:`_mesh_exchange` and count its permutes.

    The fusion structure depends only on the heap dtype, the packing
    metadata and the lane grouping — not on the ring size — so it runs on
    a one-rank mesh on the CPU (as the reference traces a one-device
    mesh)."""
    import dataclasses

    from .primitives import Communicator
    from .state import TORCH_DTYPES
    from .tables import build_tables

    cfg1 = dataclasses.replace(cfg, n_ranks=1,
                               max_comms=max(cfg.max_comms, n_comms))
    comms = [Communicator(comm_id=i, members=(0,), lane=i)
             for i in range(n_comms)]
    t = build_tables(cfg1, comms, [])
    L, B, SL = cfg1.max_comms, cfg1.burst_slices, cfg1.slice_elems

    def z(*shape, dtype=torch.int32):
        return torch.zeros((1,) + shape, dtype=dtype)

    outbox = Mailbox(fwd_count=z(L), fwd_coll=z(L),
                     fwd_payload=z(L, B, SL, dtype=TORCH_DTYPES[cfg1.dtype]),
                     rev_count=z(L), rev_coll=z(L))
    before = _ppermute.calls
    _mesh_exchange(t, [outbox])
    return _ppermute.calls - before


def _drained(st: DaemonState) -> torch.Tensor:
    """[R]: all submitted work complete on each rank."""
    return ((st.sq_read >= st.sq_size)
            & ~st.tq_active.any(1)
            & ~st.inflight.any(1))


class TickFlags(NamedTuple):
    """Progress report of one ``tick(state, k)`` call: ``steps`` supersteps
    actually ran (< k when the launch went not-live first), ``live`` is the
    fabric-wide continue flag after the tick, ``drained`` is True when
    every rank's submitted work is complete."""

    steps: torch.Tensor    # [] i32
    live: torch.Tensor     # [] bool
    drained: torch.Tensor  # [] bool


def launch_prologue(st):
    """Launch prologue: fresh launch clock + epoch tick + bounded queue-age
    rebase (of a DaemonState, or of each rank of a :class:`ShardedState`).
    Does NOT touch SQ/CQ cursors (sqcq.HostQueues.pack_sq does)."""
    if isinstance(st, ShardedState):
        return ShardedState(launch_prologue(s) for s in st.shards)
    st = st._replace(
        global_live=torch.ones_like(st.global_live),
        no_prog=torch.zeros_like(st.no_prog),
        launch_steps=torch.zeros_like(st.launch_steps),
        epoch=st.epoch + 1,
    )
    return rebase_arrivals(st)


def _tick_accounting(st: DaemonState, steps: torch.Tensor,
                     barrier: bool) -> DaemonState:
    """Stamp one tick's supersteps into the barrier/overlap split."""
    if barrier:
        return st._replace(tick_calls=st.tick_calls + 1,
                           barrier_steps=st.barrier_steps + steps)
    return st._replace(tick_calls=st.tick_calls + 1,
                       overlap_steps=st.overlap_steps + steps)


def _gate(live: torch.Tensor, new: NamedTuple, old: NamedTuple):
    """Leaf-wise ``where(live, new, old)`` over a NamedTuple of [R, ...]
    tensors; leaves updated in place (the same tensor in both) pass."""
    out = {}
    for f, n in new._asdict().items():
        o = getattr(old, f)
        if n is o:
            out[f] = n
        else:
            out[f] = torch.where(live.view((-1,) + (1,) * (n.dim() - 1)),
                                 n, o)
    return type(new)(**out)


def _relink_edges(t: StaticTables) -> tuple:
    """Static per-edge relink descriptors for the sim daemon.

    Each chain edge c -> next_coll[c] rewrites the successor's contiguous
    input span ``heap_in[:, dst_lo : dst_lo + span]`` from a build-time
    known gather of ``heap_out`` (``tables._build_chain_tables``).  Every
    offset is static, so the daemon applies the hand-off as a static slice
    (or a static gather) plus a ``where``-select per superstep: no dynamic
    scatter and no branch on the device.  When the source map is one
    contiguous run (the common chunk hand-off) the gather is a slice.

    Returns the reference's tuple of ``(c, dst_lo, span, ('slice', src_lo,
    n) | ('gather', idx_bytes))`` entries."""
    edges = []
    C = t.chain_dst.shape[0]
    for c in range(C):
        dst = t.chain_dst[c]
        valid = dst < (1 << 30)
        if not valid.any():
            continue
        span = int(valid.sum())
        dst_lo = int(dst[0])
        src = t.chain_src[c, :span]
        live = src >= 0
        n = int(live.sum())
        contiguous = (n > 0 and bool(live[:n].all()) and np.array_equal(
            src[:n], src[0] + np.arange(n, dtype=src.dtype)))
        if contiguous:
            desc = ("slice", int(src[0]), n)
        else:
            desc = ("gather", src.tobytes())
        edges.append((c, dst_lo, span, desc))
    return tuple(edges)


def _edge_plan(edges: tuple, device) -> list:
    """Unpack the relink-edge descriptors; a gather edge's index and
    validity tensors are built HERE, on the device, once per daemon (the
    superstep body that uses them is captured as a CUDA graph, where no
    host-to-device copy may run)."""
    plan = []
    for c, dst_lo, span, desc in edges:
        if desc[0] == "slice":
            plan.append((c, dst_lo, span, desc[1], desc[2], None))
        else:
            idx = np.frombuffer(desc[1], dtype=np.int32).copy()
            plan.append((c, dst_lo, span, None, None,
                         (torch.as_tensor(np.maximum(idx, 0),
                                          dtype=torch.int64, device=device),
                          torch.as_tensor(idx >= 0, device=device))))
    return plan


def _apply_relink(edge_plan: list, fired: torch.Tensor,
                  heap_in: torch.Tensor, heap_out: torch.Tensor) -> None:
    """The reference's deferred relink block, in place: per chain edge, the
    successor's input span becomes the predecessor's mapped output on the
    ranks where ``fired[:, c]``, and stays as it is elsewhere."""
    for c, dst_lo, span, src_lo, n, gather in edge_plan:
        f = fired[:, c, None]
        if gather is None:
            cur = heap_in[:, dst_lo:dst_lo + n]
            torch.where(f, heap_out[:, src_lo:src_lo + n].to(cur.dtype), cur,
                        out=cur)
            if n < span:                # zero-filled pad tail
                heap_in[:, dst_lo + n:dst_lo + span].masked_fill_(f, 0)
        else:
            idx, ok = gather
            cur = heap_in[:, dst_lo:dst_lo + span]
            vals = torch.where(ok[None, :], heap_out[:, idx], 0)
            torch.where(f, vals.to(cur.dtype), cur, out=cur)


def _sim_body_fn(cfg: OcclConfig, edge_plan=()) -> Callable:
    """ONE gated sim superstep: scheduler over all ranks + deferred chain
    relink + fabric exchange + liveness consensus, applied only where the
    fabric is still live.

    The relink fires where a chained stage completed in THIS body
    (:func:`chain_relink_fired` on the ``stage_completions`` delta) and the
    fabric is live: a gated body leaves ``heap_in`` unchanged, like every
    other leaf.  It rewrites each edge's whole span every superstep, as the
    reference's does (parity needs the same writes)."""

    def body(sh, lt, fwd_src, rev_src, st, inbox):
        live = st.global_live
        new, outbox = rank_superstep(cfg, sh, lt, st, inbox, live=live,
                                     defer_relink=True)
        if edge_plan:
            fired = (chain_relink_fired(sh, lt, st.stage_completions,
                                        new.stage_completions)
                     & live[:, None])
            _apply_relink(edge_plan, fired, new.heap_in, new.heap_out)
        new_inbox = _sim_exchange(fwd_src, rev_src, outbox)
        all_drained = _drained(new).all()
        quit_now = new.no_prog.min() >= cfg.quit_threshold
        over_budget = new.launch_steps[0] >= cfg.superstep_budget
        still = ~(all_drained | quit_now | over_budget)
        new = new._replace(global_live=still.expand_as(live))
        return _gate(live, new, st), _gate(live, new_inbox, inbox)

    return body


def _superstep_settings(cfg: OcclConfig) -> superstep.Settings:
    """The superstep kernels' scalar settings for ``cfg``."""
    return superstep.Settings(
        int(cfg.flight_recorder), int(cfg.order_policy == OrderPolicy.PRIORITY),
        int(cfg.priority_preempts), cfg.prio_aging_quantum,
        cfg.prio_aging_cap, int(cfg.stickiness), int(cfg.demand_steering),
        int(cfg.queue_conditional_stall), cfg.spin_base, cfg.spin_decr,
        cfg.spin_boost, cfg.spin_min, cfg.spin_max, cfg.quit_threshold,
        cfg.superstep_budget, QUEUE_KEY_DEMAND_STRIDE, QUEUE_KEY_PRIO_STRIDE,
        int(P.Prim.NULL), recorder.EV_SUBMIT, recorder.EV_STAGE_DONE,
        recorder.EV_PREEMPT, recorder.EV_CHAIN_HANDOFF, recorder.EV_CQE)


def _sim_step_fn(cfg: OcclConfig, edge_plan, device) -> Callable:
    """``step(sh, lt, fwd_src, rev_src, st, inbox, steps) -> (st, inbox,
    steps)``: ONE gated sim superstep, ``steps`` counting it where the
    fabric was live (rank 0's flag).  On the card the superstep kernels
    (:func:`~repro_torch.kernels.superstep.fused_superstep`), which update
    the state, the mailbox and ``steps`` IN PLACE, then the relink on the
    hand-offs they report; elsewhere :func:`_sim_body_fn`'s body, which
    returns new tensors."""
    if torch.device(device).type == "cuda":
        settings = _superstep_settings(cfg)
        chains = bool(edge_plan)

        def step(sh, lt, fwd_src, rev_src, st, inbox, steps):
            fired = superstep.fused_superstep(settings, sh, lt, fwd_src,
                                              rev_src, st, inbox, steps,
                                              chains)
            if chains:
                _apply_relink(edge_plan, fired, st.heap_in, st.heap_out)
            return st, inbox, steps

        return step
    body = _sim_body_fn(cfg, edge_plan)

    def step(sh, lt, fwd_src, rev_src, st, inbox, steps):
        steps = steps + st.global_live[0].to(torch.int32)
        return (*body(sh, lt, fwd_src, rev_src, st, inbox), steps)

    return step


def _flat(x) -> list:
    """The tensors of a NamedTuple, or of a tuple of NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


def _fresh(x, keep=()):
    """A contiguous copy of a NamedTuple of tensors, but for the fields in
    ``keep``."""
    return type(x)(*(t if f in keep
                     else t.clone(memory_format=torch.contiguous_format)
                     for f, t in zip(x._fields, x)))


def _rebuild(like, leaves):
    """Inverse of :func:`_flat`: ``like``'s structure over ``leaves`` (an
    iterator)."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    vals = [_rebuild(v, leaves) for v in like]
    return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)


class _ChunkRunner:
    """Runs ``chunk`` gated bodies at a time; on one CUDA device as ONE graph
    replay.

    ``bodies(st, inbox, k)`` runs k gated bodies and returns ``(state,
    inbox, supersteps run)``; the state is a sim DaemonState or a tuple of a
    mesh's per-rank DaemonStates (the inbox likewise).  A superstep issues
    several hundred small kernels (R times as many on a mesh), so eager
    execution is bound by the host's launch rate.  Every body is
    fixed-shape and free of host syncs, so the first full chunk of a
    runtime runs eagerly (which also warms every lazily built kernel and
    cached index tensor) and is then captured into a CUDA graph over static
    input buffers; each later full chunk copies the live leaves in,
    replays, and returns copies of the graph-owned outputs (so no caller
    ever holds a graph-owned buffer).  The heaps are the runtime's own
    tensors, updated in place: the graph reads and writes them directly and
    a replay returns them as they are, so they are neither cloned nor
    copied back.  A shorter tail chunk runs eagerly, and so does
    everything when ``graphed`` is false (CPU tensors, or a mesh over
    several devices: a CUDA graph spans one device).  Replay executes
    exactly the captured bodies, so trajectories are bit-identical to
    eager execution.  Where the bodies update their inputs IN PLACE
    (``in_place``: the sim's superstep kernels), eager bodies start from
    contiguous copies, so a caller's tensors stay as they were (the heaps
    excepted).

    The ``fused_burst`` and ``fused_superstep`` wrappers count their
    launches while the chunk is captured; those counts (the kernel launches
    the graph holds) are taken off the counters again, since the capture
    itself runs nothing, and added once per replay.

    Host counters (no device read): ``graph_captures``, ``graph_replays``,
    and the bodies run by replays (``graph_supersteps``) and eagerly
    (``eager_supersteps``: a CPU or multi-device run, a shorter chunk, the
    first chunk before its capture); the warm-up bodies of :meth:`prime`
    run from a not-live state and count as neither.  ``kernel_nodes`` is
    the captured graph's kernel node count, read from the graph once at
    capture (:func:`graph_kernel_nodes`); ``superstep_launches`` the
    ``fused_superstep`` kernel launches of the bodies it ran or replayed.
    Each call is one ``occl.chunk`` span of ``k`` units
    (:mod:`~repro_torch.core.trace`), device-timed when ``graphed``."""

    def __init__(self, bodies: Callable, chunk: int, graphed: bool,
                 in_place: bool = False):
        self.bodies, self.chunk, self.graphed = bodies, chunk, graphed
        self.in_place = in_place
        self.graph = None
        self.kernel_nodes = None
        self.graph_captures = self.graph_replays = 0
        self.graph_supersteps = self.eager_supersteps = 0
        self.superstep_launches = 0

    def __call__(self, st, inbox, k: int):
        with trace.span("occl.chunk", device=self.graphed, units=k):
            if k != self.chunk or not self.graphed:
                self.eager_supersteps += k
                return self._eager(st, inbox, k)
            if self.graph is None:
                out = self._eager(st, inbox, k)
                self.eager_supersteps += k
                self._capture(*out[:2])
                return out
            for dst, src in zip(self.static, _flat((st, inbox))):
                if dst is not src:
                    dst.copy_(src)
            self.graph.replay()
            self.graph_replays += 1
            self.graph_supersteps += k
            for wrapper, n in zip(_COUNTED, self.per_replay):
                wrapper.launches += n
            self.superstep_launches += self.per_replay[1]
            st_out, in_out, steps = self.out
            return (_rebuild(st, map(self._own, _flat(st_out))),
                    _rebuild(inbox, (t.clone() for t in _flat(in_out))),
                    steps.clone())

    def _eager(self, st, inbox, k: int):
        if self.in_place:
            st, inbox = _fresh(st, keep=("heap_in", "heap_out")), _fresh(inbox)
        before = superstep.fused_superstep.launches
        out = self.bodies(st, inbox, k)
        self.superstep_launches += superstep.fused_superstep.launches - before
        return out

    def prime(self, st: DaemonState, inbox: Mailbox) -> None:
        """Warm up and capture a sim chunk without advancing anything: the
        eager bodies run on ``st`` marked not live, so their gated writes
        change no heap element, and their outputs only shape the static
        buffers."""
        if self.graph is None and self.graphed:
            dead = st._replace(global_live=torch.zeros_like(st.global_live))
            launches = self.superstep_launches
            self._capture(*self._eager(dead, inbox, self.chunk)[:2])
            self.superstep_launches = launches

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        return t if any(t is h for h in self.heaps) else t.clone()

    def _capture(self, st, inbox) -> None:
        shards = (st,) if isinstance(st, DaemonState) else st
        self.heaps = [h for s in shards for h in (s.heap_in, s.heap_out)]
        st_in = _rebuild(st, map(self._own, _flat(st)))
        in_in = _rebuild(inbox, (t.clone() for t in _flat(inbox)))
        self.static = _flat((st_in, in_in))
        launches = [wrapper.launches for wrapper in _COUNTED]
        # keep_graph: the captured cudaGraph_t (host-side node list, no
        # device memory) outlives the capture so its nodes can be counted;
        # it is instantiated right away, as a plain capture would be.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # No garbage collection while capturing: a dead runtime's graph
        # freed mid-capture invalidates the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.out = self.bodies(st_in, in_in, self.chunk)
        finally:
            if collecting:
                gc.enable()
        self.per_replay = [wrapper.launches - n
                           for wrapper, n in zip(_COUNTED, launches)]
        for wrapper, n in zip(_COUNTED, launches):
            wrapper.launches = n
        if self.per_replay[0] <= 0:
            raise RuntimeError("the captured superstep chunk launches no "
                               "fused_burst kernel")
        self.kernel_nodes = graph_kernel_nodes(graph)
        graph.instantiate()
        self.graph = graph
        self.graph_captures += 1


_KERNEL_NODE = 0        # CU_GRAPH_NODE_TYPE_KERNEL


def graph_kernel_nodes(graph) -> int:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` built with
    ``keep_graph=True``, read from the graph itself through the driver API
    (``cuGraphGetNodes`` / ``cuGraphNodeGetType``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.restype = ctypes.c_int
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphNodeGetType.restype = ctypes.c_int
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    kind = ctypes.c_int(0)
    for node in nodes[:n.value]:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == _KERNEL_NODE
    return kernels


def chunk_stats(ticker) -> dict:
    """The host counters of a ticker's chunk runners (one per tick size),
    summed (``superstep_launches``: the ``fused_superstep`` kernels they
    launched, replays included); ``graph_kernel_nodes`` and
    ``graph_replays_by_tick`` map each captured tick size to its graph's
    kernel node count and replays."""
    runs = ticker._runners
    out = {f: sum(getattr(r, f) for r in runs.values())
           for f in ("graph_captures", "graph_replays", "graph_supersteps",
                     "eager_supersteps", "superstep_launches")}
    captured = {k: r for k, r in runs.items() if r.kernel_nodes is not None}
    out["graph_kernel_nodes"] = {k: r.kernel_nodes
                                 for k, r in captured.items()}
    out["graph_replays_by_tick"] = {k: r.graph_replays
                                    for k, r in captured.items()}
    return out


def _load_mailbox(st: DaemonState) -> Mailbox:
    """Re-inject messages that were on the wire at the last daemon exit."""
    return Mailbox(
        fwd_count=st.mb_fwd_count, fwd_coll=st.mb_fwd_coll,
        fwd_payload=st.mb_fwd_payload,
        rev_count=st.mb_rev_count, rev_coll=st.mb_rev_coll)


def _store_mailbox(st: DaemonState, inbox: Mailbox) -> DaemonState:
    return st._replace(
        mb_fwd_count=inbox.fwd_count, mb_fwd_coll=inbox.fwd_coll,
        mb_fwd_payload=inbox.fwd_payload,
        mb_rev_count=inbox.rev_count, mb_rev_coll=inbox.rev_coll)


class SimTicker:
    """The sim daemon's superstep machine: one gated body over the tables,
    shared by a daemon launch, the host-driven tick path
    (``launch_once(tick_k=...)``) and in-step ticks
    (:class:`~repro_torch.core.device_api.DeviceApi`), with one
    :class:`_ChunkRunner` (one CUDA graph on the card) per tick size.

    The body is :func:`_sim_step_fn`'s: the superstep kernels on the card
    (in place), :func:`_sim_body_fn`'s body on the CPU."""

    def __init__(self, cfg: OcclConfig, t: StaticTables, device):
        from .state import tables_from_numpy

        self.device = torch.device(device)
        self.tables = tables_from_numpy(t, device)
        self.step = _sim_step_fn(cfg, _edge_plan(_relink_edges(t), device),
                                 device)
        self._runners: dict = {}

    def _bodies(self, st: DaemonState, inbox: Mailbox, k: int):
        """k gated bodies; returns (state, inbox, supersteps actually
        run)."""
        steps = torch.zeros((), dtype=torch.int32, device=self.device)
        for _ in range(k):
            st, inbox, steps = self.step(*self.tables, st, inbox, steps)
        return st, inbox, steps

    def _runner(self, k: int) -> _ChunkRunner:
        run = self._runners.get(k)
        if run is None:
            card = self.device.type == "cuda"
            run = self._runners[k] = _ChunkRunner(self._bodies, k, card,
                                                  in_place=card)
        return run

    def run(self, st: DaemonState, inbox: Mailbox, k: int):
        """k gated bodies; returns (state, inbox, supersteps run)."""
        if k <= 0:
            return self._bodies(st, inbox, 0)
        return self._runner(k)(st, inbox, k)

    def capture(self, st: DaemonState, k: int) -> None:
        """Capture the k-body graph now, from ``st`` with the fabric marked
        not live: the warm-up bodies then change nothing (every write is
        gated), so a caller can capture before a backward pass and only
        replay inside it.  A no-op on the CPU and once captured."""
        if k > 0:
            self._runner(k).prime(st, _load_mailbox(st))

    def tick(self, st: DaemonState, k: int, barrier: bool):
        """``tick(state, k) -> (state, TickFlags)``: up to ``k`` supersteps,
        stamped into the barrier or the overlap split."""
        st, inbox, steps = self.run(st, _load_mailbox(st), int(k))
        st = _tick_accounting(_store_mailbox(st, inbox), steps, barrier)
        flags = TickFlags(steps=steps, live=st.global_live[0],
                          drained=_drained(st).all())
        return st, flags


def build_sim_tick(cfg: OcclConfig, t: StaticTables, device,
                   barrier: bool = False) -> Callable:
    """``tick(state, k) -> (state, TickFlags)``, sim backend: up to ``k``
    supersteps of the daemon loop body (state leaves carry the leading [R]
    rank axis).  ``barrier`` is the accounting tag only."""
    ticker = SimTicker(cfg, t, device)
    return lambda st, k: ticker.tick(st, k, barrier)


def build_sim_daemon(cfg: OcclConfig, ticker: SimTicker) -> Callable:
    """Daemon for the sim backend on ``ticker``'s machine: state [R, ...]
    -> state.

    One launch is the prologue plus ONE barrier tick of up to
    ``superstep_budget + 1`` supersteps (the budget check flips
    ``global_live`` first), run as gated chunks of ``TICK_CHUNK`` bodies — a
    CUDA graph replay each on the card — with one host read of the live
    flag per chunk."""
    chunk = TICK_CHUNK
    limit = cfg.superstep_budget + 1

    def daemon(st: DaemonState) -> DaemonState:
        with trace.span("occl.loop"):
            st = launch_prologue(st)
            inbox = _load_mailbox(st)
            total = torch.zeros((), dtype=torch.int32, device=st.epoch.device)
            done = 0
            while done < limit:
                k = min(chunk, limit - done)
                st, inbox, steps = ticker.run(st, inbox, k)
                total = total + steps
                done += k
                with trace.span("occl.flag_read"):
                    live = bool(st.global_live[0])
                if not live:
                    break
            return _tick_accounting(_store_mailbox(st, inbox), total, True)

    return daemon


class MeshTicker:
    """The mesh daemon's superstep machine (the reference's
    ``build_mesh_tick`` under ``shard_map``, with one controller issuing
    every rank's work): rank r's state lives on ``mesh[r]`` and its
    superstep runs there on its own slice of the tables.

    One gated body runs, for every rank, ``rank_superstep`` on that rank's
    state, the deferred chain relink (the sim's static per-edge plan, on
    the rank's heaps), then the fused exchange (:func:`_mesh_exchange`) and
    the liveness vote: the reference's ``all_gather`` of every rank's
    drained and quit flags, carried as small per-rank copies to each
    voting device.  Every leaf is gated on the device-side ``global_live``
    as in the sim, so the trajectory equals the sim's bit for bit.

    When every rank's device is the same CUDA device, each full chunk of
    all ranks' bodies and exchanges replays as ONE CUDA graph
    (:class:`_ChunkRunner`), and each rank's step and gate run on a stream
    of its own, forked from the issuing stream and joined back around the
    exchange and the vote, so that the graph holds the ranks as parallel
    branches.  A mesh over several devices runs eagerly (a CUDA graph spans
    one device), each rank's work issued under its own device."""

    def __init__(self, cfg: OcclConfig, t: StaticTables, mesh):
        from .state import resolve_mesh, tables_from_numpy

        self.cfg, self.t = cfg, t
        self.devices = resolve_mesh(mesh, cfg.n_ranks)
        per_dev: dict = {}
        self.tables = []
        for r, dev in enumerate(self.devices):
            if dev not in per_dev:
                sh, lt, _, _ = tables_from_numpy(t, dev)
                per_dev[dev] = (sh, lt, _edge_plan(_relink_edges(t), dev))
            sh, lt, plan = per_dev[dev]
            self.tables.append(
                (sh, LocalTables(*(a[r:r + 1] for a in lt)), plan))
        self.xplan = _exchange_plan(t, self.devices)
        self.vote_devices = tuple(per_dev)
        first = self.devices[0]
        self.graphed = first.type == "cuda" and len(per_dev) == 1
        self.multi = len(per_dev) > 1
        self.streams = ([torch.cuda.Stream(first) for _ in self.devices]
                        if self.graphed else None)
        self._runners: dict = {}

    def _per_rank(self, fn) -> list:
        """``fn(r)`` for every rank: under the rank's device on a mesh over
        several devices; on one card forked onto the rank's side stream
        and joined back, so that the ranks' small kernels may overlap (in
        a captured graph the ranks are parallel branches)."""
        if self.streams is None:
            out = []
            for r, dev in enumerate(self.devices):
                with (torch.cuda.device(dev) if self.multi
                      and dev.type == "cuda" else contextlib.nullcontext()):
                    out.append(fn(r))
            return out
        cur = torch.cuda.current_stream(self.devices[0])
        out = []
        for r, side in enumerate(self.streams):
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out.append(fn(r))
        for side in self.streams:
            cur.wait_stream(side)
        return out

    def _body(self, shards: tuple, inboxes: tuple):
        cfg = self.cfg

        def step(r):
            sh, lt, plan = self.tables[r]
            st = shards[r]
            live = st.global_live
            new, outbox = rank_superstep(cfg, sh, lt, st, inboxes[r],
                                         live=live, defer_relink=True)
            if plan:
                fired = (chain_relink_fired(sh, lt, st.stage_completions,
                                            new.stage_completions)
                         & live[:, None])
                _apply_relink(plan, fired, new.heap_in, new.heap_out)
            return new, outbox

        news, outboxes = zip(*self._per_rank(step))
        got = _mesh_exchange(self.t, list(outboxes), self.xplan)
        drained = [_drained(n) for n in news]
        stuck = [n.no_prog >= cfg.quit_threshold for n in news]
        vote = {d: (torch.cat([x.to(d) for x in drained]).all()
                    | torch.cat([x.to(d) for x in stuck]).all())
                for d in self.vote_devices}

        def gate(r):
            st, new = shards[r], news[r]
            over = new.launch_steps >= cfg.superstep_budget
            new = new._replace(global_live=~(vote[self.devices[r]] | over))
            return (_gate(st.global_live, new, st),
                    _gate(st.global_live, got[r], inboxes[r]))

        out_st, out_in = zip(*self._per_rank(gate))
        return tuple(out_st), tuple(out_in)

    def _bodies(self, shards: tuple, inboxes: tuple, k: int):
        steps = torch.zeros((), dtype=torch.int32, device=self.devices[0])
        for _ in range(k):
            steps = steps + shards[0].global_live[0].to(torch.int32)
            shards, inboxes = self._body(shards, inboxes)
        return shards, inboxes, steps

    def run(self, shards: tuple, inboxes: tuple, k: int):
        """k gated bodies over every rank; returns (shards, inboxes,
        supersteps run)."""
        if k <= 0:
            return self._bodies(shards, inboxes, 0)
        run = self._runners.get(k)
        if run is None:
            run = self._runners[k] = _ChunkRunner(self._bodies, k,
                                                  self.graphed)
        return run(shards, inboxes, k)

    def tick(self, st: ShardedState, k: int, barrier: bool):
        """``tick(state, k) -> (state, TickFlags)``: up to ``k`` supersteps
        of every rank, stamped into the barrier or the overlap split."""
        shards, inboxes, steps = self.run(
            st.shards, tuple(_load_mailbox(s) for s in st.shards), int(k))
        return self.finish(shards, inboxes, steps, barrier)

    def finish(self, shards: tuple, inboxes: tuple, steps: torch.Tensor,
               barrier: bool):
        """Store the in-flight mailboxes and stamp ``steps`` supersteps
        into each rank's accounting; returns (ShardedState, TickFlags)."""
        shards = tuple(
            _tick_accounting(_store_mailbox(s, mb), steps.to(dev), barrier)
            for s, mb, dev in zip(shards, inboxes, self.devices))
        dev0 = self.devices[0]
        flags = TickFlags(
            steps=steps, live=shards[0].global_live[0],
            drained=torch.cat([_drained(s).to(dev0) for s in shards]).all())
        return ShardedState(shards), flags


def build_mesh_tick(cfg: OcclConfig, t: StaticTables, mesh,
                    barrier: bool = False) -> Callable:
    """``tick(state, k) -> (state, TickFlags)`` over a mesh (one device per
    rank; the state a :class:`ShardedState`): up to ``k`` supersteps of
    every rank.  ``barrier`` is the accounting tag only."""
    ticker = MeshTicker(cfg, t, mesh)
    return lambda st, k: ticker.tick(st, k, barrier)


def build_mesh_daemon(cfg: OcclConfig, ticker: MeshTicker) -> Callable:
    """Daemon for the mesh backend on ``ticker``'s machine: a launch is the
    prologue plus ONE barrier tick of up to ``superstep_budget + 1``
    supersteps, run as gated chunks of ``TICK_CHUNK`` bodies (a CUDA graph
    replay each on one card) with one host read of the live flag per
    chunk."""
    limit = cfg.superstep_budget + 1

    def daemon(st: ShardedState) -> ShardedState:
        with trace.span("occl.loop"):
            shards = launch_prologue(st).shards
            inboxes = tuple(_load_mailbox(s) for s in shards)
            total = torch.zeros((), dtype=torch.int32,
                                device=ticker.devices[0])
            done = 0
            while done < limit:
                k = min(TICK_CHUNK, limit - done)
                shards, inboxes, steps = ticker.run(shards, inboxes, k)
                total = total + steps
                done += k
                with trace.span("occl.flag_read"):
                    live = bool(shards[0].global_live[0])
                if not live:
                    break
            return ticker.finish(shards, inboxes, total, True)[0]

    return daemon


def build_shardmap_daemon(cfg: OcclConfig, t: StaticTables, mesh,
                          axis_name: str = "rank") -> Callable:
    """Daemon over a mesh of devices, one per rank: state -> state (a
    :class:`ShardedState`).  ``axis_name`` is kept for the reference's
    signature; the port's mesh has one axis."""
    return build_mesh_daemon(cfg, MeshTicker(cfg, t, mesh))


def build_shardmap_tick(cfg: OcclConfig, t: StaticTables, mesh,
                        axis_name: str = "rank",
                        barrier: bool = False) -> Callable:
    """``tick(state, k) -> (state, TickFlags)`` over a mesh of devices
    (:func:`build_mesh_tick`; ``axis_name`` as in
    :func:`build_shardmap_daemon`)."""
    return build_mesh_tick(cfg, t, mesh, barrier)
