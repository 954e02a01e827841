"""The daemon loop, sim backend: all ranks on one device (paper Sec. 3.1).

PyTorch port of the sim half of ``repro.core.daemon``.  Per-rank state
carries the leading rank axis written out, the scheduler superstep runs over
all ranks at once, and the connector fabric is a gather along each lane's
ring permutation.  The mesh backend (one device per rank) is not ported yet
(ROADMAP.md, "Modules to port", item 5).

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
(:class:`_ChunkRunner`): a superstep is several hundred small kernels, and
issuing them one by one from the host would bound the daemon.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import OcclConfig
from . import primitives as P
from .scheduler import (
    LocalTables,
    Mailbox,
    SharedTables,
    chain_relink_fired,
    rank_superstep,
    rebase_arrivals,
)
from .state import DaemonState
from .tables import StaticTables
from ..kernels import fused_slice

# Supersteps a launch runs between two host reads of the live flag.
TICK_CHUNK = 16


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


def launch_prologue(st: DaemonState) -> DaemonState:
    """Launch prologue: fresh launch clock + epoch tick + bounded queue-age
    rebase.  Does NOT touch SQ/CQ cursors (sqcq.HostQueues.pack_sq does)."""
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


def _run_bodies(body, sh, lt, fwd_src, rev_src, st, inbox, k: int):
    """k gated bodies; returns (state, inbox, supersteps actually run)."""
    steps = torch.zeros((), dtype=torch.int32, device=st.supersteps.device)
    for _ in range(k):
        steps = steps + st.global_live[0].to(torch.int32)
        st, inbox = body(sh, lt, fwd_src, rev_src, st, inbox)
    return st, inbox, steps


class _ChunkRunner:
    """Runs ``chunk`` gated bodies at a time; on a CUDA device as ONE graph
    replay.

    A superstep issues several hundred small kernels, so eager execution is
    bound by the host's launch rate.  Every body is fixed-shape and free of
    host syncs, so the first full chunk of a runtime runs eagerly (which
    also warms every lazily built kernel and cached index tensor) and is
    then captured into a CUDA graph over static input buffers; each later
    full chunk copies the live leaves in, replays, and returns copies of the
    graph-owned outputs (so no caller ever holds a graph-owned buffer).  The
    heaps are the runtime's own tensors, updated in place: the graph reads
    and writes them directly and a replay returns them as they are, so
    they are neither cloned nor copied back.  A shorter tail chunk and CPU
    tensors run eagerly.  Replay executes exactly the captured bodies, so
    trajectories are bit-identical to eager execution.

    The ``fused_burst`` wrapper counts its launches while the chunk is
    captured; that count (the kernel launches the graph holds) is taken
    off the counter again, since the capture itself runs nothing, and
    added once per replay."""

    def __init__(self, body, tables, chunk: int):
        self.body, self.tables, self.chunk = body, tables, chunk
        self.graph = None

    def _eager(self, st, inbox, k):
        return _run_bodies(self.body, *self.tables, st, inbox, k)

    def __call__(self, st: DaemonState, inbox: Mailbox, k: int):
        if k != self.chunk or st.heap_in.device.type != "cuda":
            return self._eager(st, inbox, k)
        if self.graph is None:
            out = self._eager(st, inbox, k)
            self._capture(*out[:2])
            return out
        for dst, src in zip(self.static, (*st, *inbox)):
            if dst is not src:
                dst.copy_(src)
        self.graph.replay()
        fused_slice.fused_burst.launches += self.per_replay
        st_out, in_out, steps = self.out
        return (DaemonState(*[self._own(t) for t in st_out]),
                Mailbox(*[t.clone() for t in in_out]), steps.clone())

    def prime(self, st: DaemonState, inbox: Mailbox) -> None:
        """Warm up and capture without advancing anything: the eager bodies
        run on ``st`` marked not live, so their gated writes change no
        heap element, and their outputs only shape the static buffers."""
        if self.graph is None and st.heap_in.device.type == "cuda":
            dead = st._replace(global_live=torch.zeros_like(st.global_live))
            self._capture(*self._eager(dead, inbox, self.chunk)[:2])

    def _own(self, t: torch.Tensor) -> torch.Tensor:
        return t if any(t is h for h in self.heaps) else t.clone()

    def _capture(self, st: DaemonState, inbox: Mailbox) -> None:
        self.heaps = (st.heap_in, st.heap_out)
        st_in = DaemonState(*[self._own(t) for t in st])
        in_in = Mailbox(*[t.clone() for t in inbox])
        self.static = (*st_in, *in_in)
        launches = fused_slice.fused_burst.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = _run_bodies(self.body, *self.tables, st_in, in_in,
                                   self.chunk)
        self.per_replay = fused_slice.fused_burst.launches - launches
        fused_slice.fused_burst.launches = launches
        if self.per_replay <= 0:
            raise RuntimeError("the captured superstep chunk launches no "
                               "fused_burst kernel")
        self.graph = graph


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
    :class:`_ChunkRunner` (one CUDA graph on the card) per tick size."""

    def __init__(self, cfg: OcclConfig, t: StaticTables, device):
        from .state import tables_from_numpy

        self.tables = tables_from_numpy(t, device)
        self.body = _sim_body_fn(cfg, _edge_plan(_relink_edges(t), device))
        self._runners: dict = {}

    def _runner(self, k: int) -> _ChunkRunner:
        run = self._runners.get(k)
        if run is None:
            run = self._runners[k] = _ChunkRunner(self.body, self.tables, k)
        return run

    def run(self, st: DaemonState, inbox: Mailbox, k: int):
        """k gated bodies; returns (state, inbox, supersteps run)."""
        if k <= 0:
            return _run_bodies(self.body, *self.tables, st, inbox, 0)
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
        st = launch_prologue(st)
        inbox = _load_mailbox(st)
        total = torch.zeros((), dtype=torch.int32, device=st.epoch.device)
        done = 0
        while done < limit:
            k = min(chunk, limit - done)
            st, inbox, steps = ticker.run(st, inbox, k)
            total = total + steps
            done += k
            if not bool(st.global_live[0]):
                break
        return _tick_accounting(_store_mailbox(st, inbox), total, True)

    return daemon
