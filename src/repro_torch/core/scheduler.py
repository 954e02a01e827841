"""Per-rank daemon superstep: the core of the DFCE-framework (paper Sec. 3.1).

One superstep, per rank:
  A. apply arriving connector messages (slice-burst commits + credit counts);
  B. maybe fetch one SQE (order policy controls eagerness, Sec. 3.2);
  C. all lanes at once: select each lane's current collective (two-phase
     blocking), gate a *burst* of up to ``cfg.burst_slices`` slice moves of
     its current primitive on connector credit, execute or spin/preempt
     (spin thresholds + stickiness, Sec. 3.2);
  D. bookkeeping for voluntary quit (Sec. 3.1.3).

PyTorch port of ``repro.core.scheduler``.  Every function here works on ALL
ranks at once: state leaves carry the leading ``[R]`` rank axis written out
(the reference ``vmap``s a per-rank function instead), lanes are a second
batch axis, and the result is bit-identical to the reference's vmapped
superstep.  The translation rules that keep it so:

* **Stable ranking.**  Lane positions and the launch-prologue rebase use
  ``torch.argsort(..., stable=True)`` (``jnp.argsort`` is stable), and the
  queue front is the argmin of a tie-free composite key (key, index), so
  ties break by lowest collective id exactly as the reference's do.
* **Dropped scatters.**  The reference's ``mode="drop"`` scatters over the
  small [C]-, [CQL]- and [FR]-sized tables become one-hot masked selects
  (:func:`_set_drop` / :func:`_add_drop`): an out-of-range target matches no
  column and is dropped, and no scatter ever relies on a duplicate-index
  winner.  The inbox payload scatter writes into a sentinel row that is
  sliced off.
* **Clamped windows.**  ``lax.dynamic_slice`` clamps its start so the window
  fits; the heap windows clamp their start the same way (with the heap's
  ``B*SLICE`` scratch padding the clamp never fires on real offsets).
* **int32.**  Queue keys, strides and counters stay int32 (wrapping like
  the reference); only gather/scatter indices are widened to int64.
* **In place.**  The per-lane output windows are written into ``heap_out``
  in place (a full functional copy of a 2^24-element heap per superstep
  would dominate), and so is the chain relink into ``heap_in``; every other
  leaf is rebuilt functionally.  The ``live`` argument of
  :func:`rank_superstep` masks those writes, so a superstep run after the
  fabric went not-live leaves both heaps untouched.

The slice math of the burst (``op(payload, local)`` where-chain) always goes
through :func:`repro_torch.kernels.ops.fused_primitive_batch`, which launches
the hand-written CUDA kernel for tensors on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .config import (
    QUEUE_KEY_DEMAND_STRIDE,
    QUEUE_KEY_PRIO_STRIDE,
    OcclConfig,
    OrderPolicy,
)
from . import primitives as P
from .primitives import Prim
from .recorder import (
    EV_CHAIN_HANDOFF,
    EV_CQE,
    EV_PREEMPT,
    EV_STAGE_DONE,
    EV_SUBMIT,
    N_EVENT_KINDS,
)
from .state import DaemonState
from ..kernels import ops as kops

_I32 = torch.int32
_I32_MAX = 2 ** 31 - 1
_BIG = QUEUE_KEY_PRIO_STRIDE
_DEMAND = QUEUE_KEY_DEMAND_STRIDE


class SharedTables(NamedTuple):
    """Rank-independent static context (tensors without a rank axis)."""

    registered: torch.Tensor   # [C] bool
    kind: torch.Tensor         # [C]
    op: torch.Tensor           # [C]
    lane: torch.Tensor         # [C]
    lane_caps: torch.Tensor    # [L] — per-lane slice burst cap (<= B)
    n_steps: torch.Tensor      # [C]
    n_slices: torch.Tensor     # [C]
    n_rounds: torch.Tensor     # [C]
    in_chunked: torch.Tensor   # [C]
    out_chunked: torch.Tensor  # [C]
    base_in_off: torch.Tensor  # [C]
    base_out_off: torch.Tensor # [C]
    # Composite-chain tables (identity / sentinel when chain-free, which is
    # all the port registers yet).
    next_coll: torch.Tensor    # [C] — device-enqueued successor (-1 none)
    chain_tail: torch.Tensor   # [C] — tail stage of c's chain (self: flat)
    chain_prio_inherit: torch.Tensor  # [C] bool
    chain_mask: torch.Tensor   # [C, C] bool — stages sharing c's chain
    chain_src: torch.Tensor    # [C, M] — heap relink gather map (M == 0)
    chain_dst: torch.Tensor    # [C, M]
    # Primitive action-flag lookups (primitives.PRIM_*), on the device.
    prim_recv: torch.Tensor    # [len(Prim)] i32
    prim_send: torch.Tensor
    prim_reduce: torch.Tensor
    prim_copy: torch.Tensor
    prim_reads_in: torch.Tensor


class LocalTables(NamedTuple):
    """Per-rank static context, leading [R] axis."""

    member: torch.Tensor       # [R, C] bool
    prog_kind: torch.Tensor    # [R, C, S]
    prog_chunk: torch.Tensor   # [R, C, S]
    chain_next: torch.Tensor   # [R, C] — rank's successor stage (-1 = tail)
    chain_tail_r: torch.Tensor # [R, C] — rank's chain tail (self for flat)


class Mailbox(NamedTuple):
    """Per-lane connector traffic for one superstep (fwd burst + rev credit),
    for every rank: ``fwd_count`` / ``rev_count`` are slice / credit counts
    (0..B), not validity bools."""

    fwd_count: torch.Tensor    # [R, L] i32 — slices committed this superstep
    fwd_coll: torch.Tensor     # [R, L] i32
    fwd_payload: torch.Tensor  # [R, L, B, SLICE]
    rev_count: torch.Tensor    # [R, L] i32 — credits returned this superstep
    rev_coll: torch.Tensor     # [R, L] i32


# ---------------------------------------------------------------------------
# per-rank indexing helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device, dtype: torch.dtype
            ) -> torch.Tensor:
    """A cached ``arange`` (read-only): the superstep needs the same few
    index vectors hundreds of times, one kernel launch each if rebuilt."""
    return torch.arange(n, device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _lane_event_kinds(L: int, device: torch.device) -> torch.Tensor:
    """[1, 4L] event kinds of one superstep's lane transitions (built once
    per device: a host-to-device copy per superstep would also forbid CUDA
    graph capture)."""
    ev = torch.tensor([EV_PREEMPT, EV_STAGE_DONE, EV_CHAIN_HANDOFF, EV_CQE],
                      dtype=_I32)
    return ev.repeat_interleave(L)[None, :].to(device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r, ...]]``: per-rank gather along axis 1 (x is [R, n])."""
    flat = idx.reshape(idx.shape[0], -1).long()
    return torch.gather(x, 1, flat).reshape(idx.shape)


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[R, E] targets -> [R, E, n] one-hot; a target outside [0, n) matches
    no column (the reference's dropped scatter target)."""
    return idx.unsqueeze(-1) == _arange(n, idx.device, idx.dtype)


def _expand(vals):
    return vals.unsqueeze(-1) if torch.is_tensor(vals) else vals


def _set_drop(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].set(vals, mode="drop")`` per rank, for x [R, n] and
    idx/vals [R, E] with distinct in-range targets."""
    m = _onehot(idx, x.shape[1])
    if x.dtype == torch.bool:
        new = (m & _expand(vals)).any(1)
    else:
        new = torch.where(m, _expand(vals), 0).sum(1, dtype=x.dtype)
    return torch.where(m.any(1), new, x)


def _add_drop(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``x.at[idx].add(vals, mode="drop")`` per rank (duplicates add up)."""
    m = _onehot(idx, x.shape[1])
    return x + torch.where(m, _expand(vals), 0).sum(1, dtype=x.dtype)


def _put_where(x: torch.Tensor, idx: torch.Tensor, vals, ok: torch.Tensor
               ) -> torch.Tensor:
    """One write per rank: ``x[r, idx[r]] = vals[r]`` where ``ok[r]`` (the
    reference's ``x.at[c].set(jnp.where(ok, v, x[c]))``); idx/ok are [R]
    or [R, 1], vals a scalar or one value per rank."""
    R, n = x.shape
    m = ((idx.reshape(R, 1) == _arange(n, x.device, idx.dtype))
         & ok.reshape(R, 1))
    if torch.is_tensor(vals):
        vals = vals.reshape(R, 1)
    return torch.where(m, vals, x)


def _cumsum_excl(n: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(n, dim=1, dtype=_I32) - n


# ---------------------------------------------------------------------------
# queue keys, positions and thresholds ([R, L, C])
# ---------------------------------------------------------------------------

def _effective_prio(cfg: OcclConfig, st: DaemonState) -> torch.Tensor:
    """Live priority including the bounded queue-age bump ([R, C]); quantum
    0 returns ``st.prio`` untouched."""
    if cfg.prio_aging_quantum <= 0:
        return st.prio
    age = torch.clamp(cfg.max_colls + st.launch_steps[:, None] - st.arrival,
                      min=0)
    bump = torch.clamp(torch.div(age, cfg.prio_aging_quantum,
                                 rounding_mode="floor"),
                       max=cfg.prio_aging_cap)
    return torch.clamp(st.prio + bump, -512, 512)


def _lane_keys(cfg: OcclConfig, st: DaemonState, shared: SharedTables,
               local: LocalTables):
    """Ascending queue-order key per collective for every lane at once.

    Returns (eligible [R, L, C], key [R, L, C] int32)."""
    L = cfg.max_comms
    lanes = _arange(L, st.arrival.device, _I32)
    eligible = ((st.tq_active & local.member)[:, None, :]
                & (shared.lane[None, None, :] == lanes[None, :, None]))
    key = st.arrival[:, None, :]
    if cfg.demand_steering:
        demand = (st.tail < st.head_mirror).to(_I32)
        key = key - demand[:, None, :] * _DEMAND
    if cfg.order_policy == OrderPolicy.PRIORITY:
        key = (-_effective_prio(cfg, st))[:, None, :] * _BIG + key
    key = torch.where(eligible, key, _I32_MAX)
    return eligible, key


def _lane_positions(key: torch.Tensor) -> torch.Tensor:
    """Task-queue position per (lane, collective): the stable double
    argsort of the reference (ties broken by index)."""
    order = torch.argsort(key, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(_I32)


def _queue_front(key: torch.Tensor) -> torch.Tensor:
    """argmin over collectives with ties broken by the lowest index (the
    reference's ``jnp.argmin``): the composite key ``key * C + index`` is
    tie-free, so the argmin is unambiguous on every device."""
    C = key.shape[-1]
    idx = _arange(C, key.device, torch.int64)
    return torch.argmin(key.to(torch.int64) * C + idx, dim=-1).to(_I32)


def _thresholds(cfg: OcclConfig, st: DaemonState, pos: torch.Tensor
                ) -> torch.Tensor:
    """Effective spin thresholds (stickiness scheme, Sec. 3.2); [R, L, C]."""
    if cfg.stickiness:
        base = cfg.spin_base - pos * cfg.spin_decr + st.boost[:, None, :]
    else:
        base = torch.full_like(pos, cfg.spin_base)
    return torch.clamp(base, cfg.spin_min, cfg.spin_max)


def rebase_arrivals(st: DaemonState) -> DaemonState:
    """Launch prologue: re-express queue age on the fresh launch clock.

    Active collectives keep their relative order but their ``arrival``
    values are compressed to queue ranks (< C, ties broken by lowest
    collective id); inactive slots reset to 0."""
    key = torch.where(st.tq_active, st.arrival, _I32_MAX)
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True).to(_I32)
    return st._replace(arrival=torch.where(st.tq_active, ranks, 0))


# ---------------------------------------------------------------------------
# phase A: inbox
# ---------------------------------------------------------------------------

def apply_inbox(cfg: OcclConfig, st: DaemonState, inbox: Mailbox
                ) -> DaemonState:
    """Phase A: commit arriving slice bursts into the recv-connector slots
    and arriving credit counts into the send-side tail mirror.  The
    (coll, slot) grid is flattened into one scatter over the [C*K, SLICE]
    payload view; masked entries go to a sentinel row that is sliced off
    (lanes are collective-disjoint, so real targets never collide)."""
    K, B, C = cfg.conn_depth, cfg.burst_slices, cfg.max_colls
    R, L = inbox.fwd_count.shape
    dev = st.payload.device
    bidx = _arange(B, dev, _I32)

    c = torch.clamp(inbox.fwd_coll, 0, C - 1)                 # [R, L]
    cnt = torch.clamp(inbox.fwd_count, 0, B)                  # [R, L]
    take = bidx[None, None, :] < cnt[:, :, None]              # [R, L, B]
    slot = (_take(st.head_mirror, c)[:, :, None] + bidx) % K
    flat = torch.where(take, c[:, :, None] * K + slot, C * K).long()
    SL = st.payload.shape[-1]
    rows = torch.cat([st.payload.reshape(R, C * K, SL),
                      st.payload.new_zeros(R, 1, SL)], dim=1)
    rr = _arange(R, dev, torch.int64)[:, None, None]
    rows[rr, flat] = inbox.fwd_payload.to(st.payload.dtype)
    payload = rows[:, :C * K].reshape(st.payload.shape)
    head_mirror = st.head_mirror.scatter_add(1, c.long(), cnt)

    rc = torch.clamp(inbox.rev_coll, 0, C - 1)
    tail_mirror = st.tail_mirror.scatter_add(
        1, rc.long(), torch.clamp(inbox.rev_count, min=0))
    return st._replace(
        head_mirror=head_mirror, tail_mirror=tail_mirror, payload=payload)


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _record_events(cfg: OcclConfig, st: DaemonState, kinds: torch.Tensor,
                   colls: torch.Tensor, valid: torch.Tensor) -> DaemonState:
    """Append masked events ([R, E]) to every rank's flight-recorder ring.

    Exclusive-cumsum slot assignment over the valid mask; all but the
    newest ``recorder_len`` events of an over-long batch are pre-dropped,
    so the ring write never maps two events onto one slot.  ``fr_kinds``
    counts every valid event (dropped ones too)."""
    if not cfg.flight_recorder:
        return st
    FR = cfg.recorder_len
    kinds = kinds.expand_as(colls)
    n = valid.to(_I32)
    off = _cumsum_excl(n)
    total = n.sum(1, dtype=_I32)
    keep = valid & (off >= (total - FR)[:, None])
    slot = (st.fr_count[:, None] + off) % FR
    tgt = torch.where(keep, slot, FR)
    ktgt = torch.where(valid, kinds, N_EVENT_KINDS)
    return st._replace(
        fr_kind=_set_drop(st.fr_kind, tgt, kinds),
        fr_coll=_set_drop(st.fr_coll, tgt, colls),
        fr_step=_set_drop(st.fr_step, tgt,
                          st.supersteps[:, None].expand_as(tgt)),
        fr_count=st.fr_count + total,
        fr_kinds=_add_drop(st.fr_kinds, ktgt, 1),
    )


# ---------------------------------------------------------------------------
# phase B: SQ fetch
# ---------------------------------------------------------------------------

def fetch_sqe(cfg: OcclConfig, st: DaemonState, shared: SharedTables,
              local: LocalTables) -> tuple[DaemonState, torch.Tensor]:
    """Phase B: pop at most one SQE per rank into the task queue (paper
    Sec. 3.1.2).  FIFO fetches lazily (queue empty or stuck); PRIORITY
    fetches eagerly every superstep.  Returns (state, fetched [R])."""
    C = cfg.max_colls
    has_sqe = st.sq_read < st.sq_size
    if cfg.order_policy == OrderPolicy.PRIORITY:
        want = has_sqe
    else:
        want = has_sqe & (~st.made_prog_prev | ~st.tq_active.any(1))
    slot = torch.clamp(st.sq_read, 0, cfg.sq_len - 1)[:, None]   # [R, 1]
    c_raw = _take(st.sq_coll, slot)                              # [R, 1]
    # An empty slot holds -1: every write below is gated on ``ok``, so any
    # in-range stand-in index leaves the state unchanged.
    c = torch.clamp(c_raw, 0, C - 1)
    ok = ((want[:, None] & (c_raw >= 0) & ~_take(st.inflight, c)
           & _take(local.member, c) & shared.registered[c.long()]))
    okv = ok[:, 0]
    qlen = st.tq_active.sum(1, dtype=_I32)
    sq_prio = _take(st.sq_prio, slot)
    sq_in = _take(st.sq_in, slot)
    sq_out = _take(st.sq_out, slot)

    # Per-SQE out_off overrides resolve END-TO-END on the rank's chain
    # tail (== c for flat collectives, where the second write is a no-op).
    tail = _take(local.chain_tail_r, c)
    use_ovr = (sq_out >= 0) & (tail == shared.chain_tail[c.long()])
    resolved_out = torch.where(use_ovr, sq_out,
                               shared.base_out_off[tail.long()])
    out_off = _put_where(st.out_off, tail, resolved_out, okv)
    out_off = _put_where(out_off, c, shared.base_out_off[c.long()],
                         okv & (tail != c)[:, 0])
    in_val = torch.where(sq_in >= 0, sq_in, shared.base_in_off[c.long()])
    arrival = cfg.max_colls + st.launch_steps[:, None]
    st = st._replace(
        tq_active=_put_where(st.tq_active, c, True, okv),
        inflight=st.inflight | (shared.chain_mask[c[:, 0].long()] & ok),
        arrival=_put_where(st.arrival, c, arrival, okv),
        prio=_put_where(st.prio, c, torch.clamp(sq_prio, -512, 512), okv),
        in_off=_put_where(st.in_off, c, in_val, okv),
        out_off=out_off,
        ctx_step=_put_where(st.ctx_step, c, 0, okv),
        ctx_slice=_put_where(st.ctx_slice, c, 0, okv),
        ctx_round=_put_where(st.ctx_round, c, 0, okv),
        spin=_put_where(st.spin, c, 0, okv),
        boost=_put_where(st.boost, c, 0, okv),
        qlen_at_fetch=_put_where(st.qlen_at_fetch, c, qlen[:, None], okv),
        fetch_step=_put_where(st.fetch_step, c, st.supersteps[:, None], okv),
        sq_read=st.sq_read + okv.to(_I32),
    )
    st = _record_events(
        cfg, st,
        kinds=torch.full_like(c_raw, EV_SUBMIT),
        colls=c_raw,
        valid=ok)
    return st, okv


# ---------------------------------------------------------------------------
# phase C: all lanes
# ---------------------------------------------------------------------------

def _window_index(base: torch.Tensor, width: int, heap_len: int
                  ) -> torch.Tensor:
    """[R, width] int64 indices of the ``lax.dynamic_slice`` window starting
    at ``base`` [R], with the start clamped so the window fits."""
    start = torch.clamp(base, 0, heap_len - width).long()
    return start[:, None] + _arange(width, base.device, torch.int64)


def lanes_step(cfg: OcclConfig, st: DaemonState, shared: SharedTables,
               local: LocalTables, live: torch.Tensor | None = None,
               defer_relink: bool = False
               ) -> tuple[DaemonState, torch.Tensor, Mailbox]:
    """Phase C for ALL lanes of ALL ranks: two-phase-blocking selection + one
    credit-gated slice burst per lane.  ``live`` [R] masks the in-place
    heap writes (see module docstring).

    ``defer_relink`` skips the in-step chain relink: the caller applies it
    after the step from the ``stage_completions`` delta
    (:func:`chain_relink_fired`; the sim daemon does, with static per-edge
    slices).  The reference's ``cond_relink`` (a ``lax.cond`` around the
    relink on the mesh backend) is a JAX tracing choice: eager PyTorch has
    one meaning for it, so it does not come across.

    Returns (state, moved_any [R], outbox)."""
    K, SL, B = cfg.conn_depth, cfg.slice_elems, cfg.burst_slices
    C, L = cfg.max_colls, cfg.max_comms
    R = st.cur.shape[0]
    dev = st.cur.device
    rr = _arange(R, dev, torch.int64)[:, None]
    bidx = _arange(B, dev, _I32)

    eligible, key = _lane_keys(cfg, st, shared, local)
    pos = _lane_positions(key)
    thr = _thresholds(cfg, st, pos)

    cur = st.cur                                              # [R, L]
    cur_c = torch.clamp(cur, 0, C - 1)
    cur_cl = cur_c.long().unsqueeze(-1)
    cur_ok = (cur >= 0) & torch.gather(eligible, 2, cur_cl).squeeze(-1)
    overspun = cur_ok & (_take(st.spin, cur_c)
                         > torch.gather(thr, 2, cur_cl).squeeze(-1))
    if cfg.priority_preempts:
        ep = _effective_prio(cfg, st)
        higher = (eligible & (ep[:, None, :]
                              > _take(ep, cur_c)[:, :, None])).any(2)
        overspun = overspun | (cur_ok & higher)

    # Preempt: rotate the overspun collective to the back of its queue.
    rot = torch.zeros_like(st.spin).scatter_add(
        1, cur_c.long(), overspun.to(_I32)) > 0
    st = st._replace(
        preempts=st.preempts + rot.to(_I32),
        arrival=torch.where(rot, cfg.max_colls + st.launch_steps[:, None] + 1,
                            st.arrival),
        spin=torch.where(rot, 0, st.spin),
        boost=torch.where(rot, 0, st.boost),
    )
    keep = cur_ok & ~overspun

    # Queue front after a possible rotation (only `arrival` changed).
    eligible, key = _lane_keys(cfg, st, shared, local)
    front = _queue_front(key)                                 # [R, L]
    any_eligible = eligible.any(2)
    cand = torch.where(keep, cur, torch.where(any_eligible, front, -1))
    c = torch.clamp(cand, 0, C - 1)                           # [R, L]
    cl = c.long()
    valid = cand >= 0
    cv = torch.where(valid, c, C)                             # valid-gated

    # --- gate a slice burst of the current primitive ---------------------
    ctx_step_c = _take(st.ctx_step, cl)
    step = torch.clamp(ctx_step_c, 0, local.prog_kind.shape[2] - 1).long()
    prim = local.prog_kind[rr, cl, step]                      # [R, L]
    chunk = local.prog_chunk[rr, cl, step]
    sl = _take(st.ctx_slice, cl)
    primi = prim.long()
    needs_recv = shared.prim_recv[primi] > 0
    needs_send = shared.prim_send[primi] > 0
    does_reduce = shared.prim_reduce[primi] > 0
    does_copy = shared.prim_copy[primi] > 0
    reads_in = shared.prim_reads_in[primi] > 0

    nsl = shared.n_slices[cl]
    tail_c = _take(st.tail, cl)
    recv_avail = _take(st.head_mirror, cl) - tail_c
    send_free = K - (_take(st.head, cl) - _take(st.tail_mirror, cl))
    Bl = shared.lane_caps[None, :]                            # [1, L]
    quota = P.burst_quota(Bl, nsl - sl, recv_avail, send_free,
                          needs_recv, needs_send)
    gate = valid & (prim != int(Prim.NULL)) & (quota > 0)
    n = torch.where(gate, quota, 0)                           # burst size
    want = torch.minimum(Bl, torch.clamp(nsl - sl, min=1))
    denied = torch.clamp(want - n, min=1)
    if cfg.queue_conditional_stall:
        solo = eligible.sum(2) <= 1
        stalled = torch.where(solo, 1, denied)
    else:
        stalled = denied

    # --- execute the fused actions on the burst (paper Fig. 3) -----------
    slots = ((tail_c[:, :, None] + bidx) % K).long()           # [R, L, B]
    recv_val = st.payload[rr[:, :, None], cl[:, :, None], slots]
    rnd = _take(st.ctx_round, cl)
    chunk_stride = shared.n_rounds[cl] * nsl * SL
    within = (rnd * nsl + sl) * SL
    in_base = (_take(st.in_off, cl)
               + torch.where(shared.in_chunked[cl] > 0, chunk, 0)
               * chunk_stride + within)
    out_base = (_take(st.out_off, cl)
                + torch.where(shared.out_chunked[cl] > 0, chunk, 0)
                * chunk_stride + within)
    W = B * SL
    H = st.heap_in.shape[1]
    in_idx = torch.cat([_window_index(in_base[:, l], W, H)
                        for l in range(L)], dim=1)            # [R, L*W]
    in_val = torch.gather(st.heap_in, 1, in_idx).reshape(R, L, B, SL)

    flags = torch.stack([needs_recv.to(_I32), does_reduce.to(_I32),
                         reads_in.to(_I32), shared.op[cl]], dim=-1)
    flags = flags[:, :, None, :].expand(R, L, B, 4).reshape(R * L * B, 4)
    value = kops.fused_primitive_batch(
        recv_val.reshape(R * L * B, SL), in_val.reshape(R * L * B, SL),
        flags.contiguous()).reshape(R, L, B, SL)

    # Per-lane [B*SL] read-modify-write windows, in lane order (a later
    # lane's window wins where two overlap, as in the reference's
    # sequential dynamic_update_slice loop), updated in place.
    write_out = gate & does_copy
    if live is not None:
        write_out = write_out & live[:, None]
    out_limit = torch.where(write_out, n, 0) * SL             # [R, L]
    vals = value.reshape(R, L, W).to(st.heap_out.dtype)
    span = _arange(W, dev, torch.int64)
    heap_out = st.heap_out
    for l in range(L):
        idx = _window_index(out_base[:, l], W, H)
        window = torch.gather(heap_out, 1, idx)
        blend = torch.where(span[None, :] < out_limit[:, l, None],
                            vals[:, l], window)
        heap_out.scatter_(1, idx, blend)

    n_recv = torch.where(gate & needs_recv, n, 0)
    n_send = torch.where(gate & needs_send, n, 0)

    # --- advance the dynamic context (round, primitive, slice) -----------
    new_slice = sl + n
    step_done = gate & (new_slice >= nsl)
    seq_done = step_done & (ctx_step_c + 1 >= shared.n_steps[cl])
    next_step = torch.where(
        seq_done, 0, torch.where(step_done, ctx_step_c + 1, ctx_step_c))
    next_slice = torch.where(step_done, 0, new_slice)
    next_round = torch.where(seq_done, rnd + 1, rnd)
    coll_done = seq_done & (next_round >= shared.n_rounds[cl])

    cg = torch.where(gate, c, C)                              # gate-gated
    st = st._replace(
        heap_out=heap_out,
        tail=st.tail.scatter_add(1, cl, n_recv),
        head=st.head.scatter_add(1, cl, n_send),
        ctx_step=_set_drop(st.ctx_step, cg, next_step),
        ctx_slice=_set_drop(st.ctx_slice, cg, next_slice),
        ctx_round=_set_drop(st.ctx_round, cg, next_round),
        spin=_set_drop(st.spin, cv,
                       torch.where(gate, 0, _take(st.spin, cl) + stalled)),
        # Denied slices always accumulate (partial denials included).
        stall_slices=_add_drop(
            st.stall_slices, cv,
            torch.where(gate, torch.clamp(want - n, min=0), denied)),
        # Stickiness: a successful primitive boosts its successors' spin
        # thresholds (gang-convergence pressure, Sec. 3.2).
        boost=st.boost.scatter_add(1, cl, torch.where(
            step_done & ~coll_done & cfg.stickiness, cfg.spin_boost, 0
        ).to(_I32)),
        slices_moved=st.slices_moved + n.sum(1, dtype=_I32),
    )

    # --- completion + chain advance ---------------------------------------
    succ = _take(local.chain_next, cl)                         # [R, L]
    succ_c = torch.clamp(succ, 0, C - 1)
    succ_cl = succ_c.long()
    chain_adv = coll_done & (succ >= 0)
    logical_done = coll_done & (succ < 0)
    done_i = logical_done.to(_I32)
    cq_slot = (st.cq_count[:, None] + _cumsum_excl(done_i)) % cfg.cq_len
    cq_tgt = torch.where(logical_done, cq_slot, cfg.cq_len)
    cd = torch.where(coll_done, c, C)
    # Inflight clears CHAIN-WIDE at logical completion.
    clear = (shared.chain_mask[cl] & logical_done[:, :, None]).any(1)
    sc = torch.where(chain_adv, succ_c, C)
    succ_prio = torch.where(shared.chain_prio_inherit[succ_cl],
                            _take(st.prio, cl), 0)
    sc_mid = torch.where(chain_adv & (_take(local.chain_next, succ_c) >= 0),
                         succ_c, C)
    st = st._replace(
        tq_active=_set_drop(_set_drop(st.tq_active, cd, False), sc, True),
        inflight=st.inflight & ~clear,
        completed=st.completed.scatter_add(1, cl, done_i),
        stage_completions=st.stage_completions.scatter_add(
            1, cl, coll_done.to(_I32)),
        rtc_latency=_add_drop(st.rtc_latency, cd,
                              st.supersteps[:, None] - _take(st.fetch_step, cl)),
        rtc_events=_add_drop(st.rtc_events, cd, 1),
        fetch_step=_set_drop(st.fetch_step, sc,
                             st.supersteps[:, None].expand_as(sc)),
        arrival=_set_drop(st.arrival, sc, (cfg.max_colls + 1
                                           + st.launch_steps[:, None]
                                           ).expand_as(sc)),
        prio=_set_drop(st.prio, sc, succ_prio),
        ctx_step=_set_drop(st.ctx_step, sc, 0),
        ctx_slice=_set_drop(st.ctx_slice, sc, 0),
        ctx_round=_set_drop(st.ctx_round, sc, 0),
        spin=_set_drop(st.spin, sc, 0),
        boost=_set_drop(st.boost, sc, 0),
        in_off=_set_drop(st.in_off, sc, shared.base_in_off[succ_cl]),
        out_off=_set_drop(st.out_off, sc_mid, shared.base_out_off[succ_cl]),
        cq_coll=_set_drop(st.cq_coll, cq_tgt, c),
        cq_count=st.cq_count + done_i.sum(1, dtype=_I32),
        cur=torch.where(coll_done | ~valid, -1, cand),
    )

    # Flight recorder: one batched ring append for this superstep's
    # transitions (preemptions, stage completions, hand-offs, CQEs).
    if cfg.flight_recorder:
        st = _record_events(
            cfg, st,
            kinds=_lane_event_kinds(L, dev),
            colls=torch.cat([cur_c, c, c, c], dim=1),
            valid=torch.cat([overspun, coll_done, chain_adv, logical_done],
                            dim=1))

    # Chain hand-off relink: rewrite the successor's padded input span in
    # heap_in from the predecessor's just-finalized heap_out region via the
    # registration-time composed stage maps (pads zero-filled).  Only when
    # the registration has chains (M > 0).  Row c describes the GLOBAL edge
    # c -> next_coll[c], so it fires only where this rank's successor IS
    # that stage (a partial-membership rank skipping it hands off nothing).
    if shared.chain_src.shape[1] > 0 and not defer_relink:
        relink_adv = chain_adv & (succ == shared.next_coll[cl])
        if live is not None:
            relink_adv = relink_adv & live[:, None]
        _relink_in_step(st.heap_in, st.heap_out, shared, cl, relink_adv)

    outbox = Mailbox(
        fwd_count=n_send,
        fwd_coll=c,
        fwd_payload=value.to(st.payload.dtype),
        rev_count=n_recv,
        rev_coll=c,
    )
    return st, gate.any(1), outbox


def _relink_in_step(heap_in: torch.Tensor, heap_out: torch.Tensor,
                    shared: SharedTables, cl: torch.Tensor,
                    adv: torch.Tensor) -> None:
    """The reference's in-step relink scatter (``heap_in.at[dst].set(vals,
    mode="drop")``), in place, lane by lane.  A target that must not be
    written (its row does not fire, or it is the out-of-range sentinel,
    clamped to the heap's last element) writes back the value it read.
    A row's real targets are distinct and lie below ``heap_elems``, and
    the clamped sentinels land in the window scratch tail, so no two
    writes to one element ever disagree."""
    H = heap_in.shape[1]
    for l in range(cl.shape[1]):
        src = shared.chain_src[cl[:, l]].long()               # [R, M]
        dst = shared.chain_dst[cl[:, l]].long()
        vals = torch.where(src >= 0,
                           torch.gather(heap_out, 1, src.clamp(min=0)), 0)
        ok = adv[:, l, None] & (dst < H)
        idx = dst.clamp(max=H - 1)
        cur = torch.gather(heap_in, 1, idx)
        heap_in.scatter_(1, idx, torch.where(ok, vals.to(heap_in.dtype),
                                             cur))


def chain_relink_fired(shared: SharedTables, local: LocalTables,
                       prev_stage_completions: torch.Tensor,
                       stage_completions: torch.Tensor) -> torch.Tensor:
    """[R, C] mask of chained stages whose hand-off relink must fire on each
    rank this superstep, recovered from the ``stage_completions`` delta.

    Matches the in-step ``relink_adv`` gating of :func:`lanes_step`: the
    stage completed here this superstep AND this rank's chain successor is
    the stage's GLOBAL next stage."""
    return ((stage_completions > prev_stage_completions)
            & (local.chain_next == shared.next_coll[None, :])
            & (shared.next_coll >= 0)[None, :])


def rank_superstep(cfg: OcclConfig, shared: SharedTables, local: LocalTables,
                   st: DaemonState, inbox: Mailbox,
                   live: torch.Tensor | None = None,
                   defer_relink: bool = False
                   ) -> tuple[DaemonState, Mailbox]:
    """One full superstep for every rank (the reference's per-rank
    ``rank_superstep`` under ``vmap``).  ``defer_relink`` as in
    :func:`lanes_step`; the relink, like the heap_out windows, writes
    ``heap_in`` in place."""
    st = apply_inbox(cfg, st, inbox)
    st, fetched = fetch_sqe(cfg, st, shared, local)
    st, moved_any, outbox = lanes_step(cfg, st, shared, local, live=live,
                                       defer_relink=defer_relink)
    progress = moved_any | fetched
    st = st._replace(
        supersteps=st.supersteps + 1,
        launch_steps=st.launch_steps + 1,
        no_prog=torch.where(progress, 0, st.no_prog + 1),
        made_prog_prev=moved_any,
    )
    return st, outbox
