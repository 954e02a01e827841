"""Expert-parallel MoE dispatch/combine routed through OCCL all-to-all.

PyTorch port of ``repro.train.occl_moe``.  The expert-parallel layout
shards the routed experts across ranks (rank d owns the ``E/R`` contiguous
experts ``d*E/R .. (d+1)*E/R - 1``) while tokens stay data-parallel.  Each
MoE layer then needs TWO personalized exchanges per step — dispatch (token
slots travel to their experts' owners) and combine (expert outputs travel
back) — and those are exactly the chained, differently-ordered all-to-alls
that wedge a statically-sequenced executor when two layers interleave
across ranks.  Through OCCL the ranks submit in ANY order and the daemon
resolves the schedule (paper Sec. 3).

Layout contract (what makes a PLAIN ``CollKind.ALL_TO_ALL`` fit): every
(source rank, expert) pair gets the same ``cap`` token slots, so the
per-destination granule is a fixed ``E/R * cap * D`` elements and the wire
payload is dense — dropped slots travel as zeros, which the bias-free
SwiGLU experts map back to zeros.  The dispatch is the sort-based capacity
dispatch of :mod:`repro_torch.models.moe` on the rank-local tokens.

The combine sums each token's expert outputs in a FIXED order (ascending
expert id, the slot order in which the reference's sequential scatter-add
visits them) by gathering through the dispatch permutation, instead of a
duplicate-index scatter-add, whose order a CUDA device does not fix.  So
:func:`ep_forward_ref` (the same per-rank stages with direct indexing as
the transport) and ``OcclMoE.forward`` agree bit for bit on any device:
the all-to-all moves bits and does no arithmetic.

The per-rank stages are PyTorch tensor code on the runtime's device; the
barrier path stages payloads through the host like the reference (one
batched heap flush per exchange), the overlapped path writes them in
place through :class:`~repro_torch.core.device_api.DeviceApi`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core import CollKind, OcclConfig, OcclRuntime
from ..core.daemon import TICK_CHUNK, _drained
from ..core.errors import StepTimeout
from ..models import moe as M

WAIT_CHUNK = 8        # supersteps per tick of a dispatch-arrival wait


# Uniform per-(source rank, expert) slot count: the moe.py formula applied
# to the rank-local token count.
_capacity = M.capacity


# ---------------------------------------------------------------------------
# the three per-rank stages (shared verbatim by OCCL path and reference)
# ---------------------------------------------------------------------------

def _dispatch_local_t(cfg, params, x, cap: int):
    """One rank's dispatch: the [E, cap, D] float32 dispatch buffer (empty
    slots zeroed), the slot metadata ``tok_idx`` / ``w`` [E, cap] and
    ``slots`` [T_l, k], each token's flat slot per assignment in ascending
    expert order (``E * cap`` where capacity dropped it)."""
    E, k = cfg.n_experts, cfg.top_k
    xt = x.float()
    _, topv, topi = M.route(params["router"], xt, k)
    order, starts, tok_idx, w, valid = M.sort_dispatch(topi, topv, E, cap)
    xe = torch.where(valid[..., None], xt[tok_idx],
                     torch.zeros((), device=xt.device))
    slots = M.assignment_slots(topi, order, starts, cap)
    slots = slots.gather(1, torch.argsort(topi, dim=1))
    return xe, tok_idx, w, slots


def _dispatch_local(cfg, params, x, cap: int):
    """The flat destination-major dispatch payload (expert-major IS
    destination-rank-major under the contiguous expert sharding) and the
    ``(tok_idx, w, slots)`` metadata the combine needs back at this
    rank."""
    xe, tok_idx, w, slots = _dispatch_local_t(cfg, params, x, cap)
    return xe.reshape(-1), (tok_idx, w, slots)


def _expert_ffn(params, rank: int, n_ranks: int, recv, epr: int, cap: int,
                d_model: int) -> torch.Tensor:
    """This rank's expert shard over the received origin-major dispatch
    buffer; returns the origin-major combine payload (granule o = the
    outputs of origin o's slots, headed back to o)."""
    xe = recv.float().reshape(n_ranks, epr, cap, d_model)
    xe = xe.transpose(0, 1).reshape(epr, n_ranks * cap, d_model)
    sl = slice(rank * epr, (rank + 1) * epr)
    wg = params["wg"][sl].float()
    wu = params["wu"][sl].float()
    wd = params["wd"][sl].float()
    h = torch.einsum("ecd,edf->ecf", xe, wg)
    u = torch.einsum("ecd,edf->ecf", xe, wu)
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * u, wd)
    ye = ye.reshape(epr, n_ranks, cap, d_model).transpose(0, 1)
    return ye.reshape(-1)


def _expert_ffn_batched(params, recv, n_ranks: int, epr: int, cap: int,
                        d_model: int) -> torch.Tensor:
    """All owner ranks' expert shards in ONE batched product over the
    received origin-major buffers ``recv`` [R, R * epr * cap * D]; returns
    the [R, n] origin-major combine payloads."""
    R = n_ranks
    xe = recv.float().reshape(R, R, epr, cap, d_model)
    xe = xe.transpose(1, 2).reshape(R, epr, R * cap, d_model)
    wg = params["wg"].float().reshape(R, epr, d_model, -1)
    wu = params["wu"].float().reshape(R, epr, d_model, -1)
    wd = params["wd"].float().reshape(R, epr, -1, d_model)
    h = torch.einsum("recd,redf->recf", xe, wg)
    u = torch.einsum("recd,redf->recf", xe, wu)
    ye = torch.einsum("recf,refd->recd", F.silu(h) * u, wd)
    ye = ye.reshape(R, epr, R, cap, d_model).transpose(1, 2)
    return ye.reshape(R, -1)


def _combine_local(params, x, recv, w, slots) -> torch.Tensor:
    """Weighted sum of the returned expert outputs onto the local tokens
    (+ the replicated shared-expert path).  ``recv`` arrives expert-owner-
    major = expert-major, aligned with ``w``; each token adds its slots'
    contributions one at a time in ascending expert order (module
    docstring), a dropped assignment adding the zero row."""
    Tl, D = x.shape
    ye = recv.float().reshape(-1, D)
    contrib = torch.cat([ye * w.reshape(-1)[:, None],
                         torch.zeros((1, D), device=ye.device)])
    y = torch.zeros((Tl, D), device=ye.device)
    for j in range(slots.shape[1]):
        y = y + contrib[slots[:, j]]
    if "shared_wg" in params:
        xt = x.float()
        hs = F.silu(xt @ params["shared_wg"].float()) * (
            xt @ params["shared_wu"].float())
        y = y + hs @ params["shared_wd"].float()
    return y


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def a2a_exchange_ref(payloads: Sequence[torch.Tensor]) -> list:
    """Direct-indexing personalized exchange — the transport oracle the
    OCCL path must match bit for bit."""
    R = len(payloads)
    c = payloads[0].numel() // R
    return [torch.cat([payloads[o][m * c:(m + 1) * c] for o in range(R)])
            for m in range(R)]


def ep_forward_ref(cfg, params, xs: Sequence, cap: Optional[int] = None):
    """Expert-parallel reference: the same three per-rank stages with
    direct indexing as the transport.  Returns one [T_l, D] output per
    rank."""
    R = len(xs)
    epr = cfg.n_experts // R
    cap = cap or _capacity(xs[0].shape[0], cfg.top_k, cfg.n_experts,
                           cfg.capacity_factor)
    disp, meta = [], []
    for r in range(R):
        xe, m = _dispatch_local(cfg, params, xs[r], cap)
        disp.append(xe)
        meta.append(m)
    recv = a2a_exchange_ref(disp)
    comb = [_expert_ffn(params, d, R, recv[d], epr, cap, cfg.d_model)
            for d in range(R)]
    back = a2a_exchange_ref(comb)
    return [_combine_local(params, xs[r], back[r], *meta[r][1:])
            for r in range(R)]


class OcclMoE:
    """MoE dispatch + combine over two registered OCCL ALL_TO_ALLs.

    The runtime is self-sized from the layer shape (the OcclGradSync
    idiom): one communicator, two collectives (dispatch, combine), heap
    scaled to the ``E * cap * D`` payload.  ``hierarchy=(G, N)`` routes
    both exchanges through the composite two-level all-to-all instead of
    the flat relay ring; ``algo="auto"`` lets the fitted cost model pick.
    ``device``: where the runtime lives (``None``: ``cuda``, raising
    without a card).
    """

    def __init__(self, cfg, n_ranks: int, tokens_per_rank: int,
                 cap: Optional[int] = None, algo: str = "ring",
                 hierarchy: Optional[tuple] = None, slice_elems: int = 128,
                 n_streams: int = 1, overlap_ticks: int = 4, device=None):
        """``n_streams=S`` additionally registers S stream-sharded
        dispatch and S combine all-to-alls (the capacity axis split into
        S independent exchanges of ``E * cap/S * D`` elements) for
        :meth:`forward_overlapped`: expert FFN compute on shard s starts
        while the dispatch tails of shards > s are still in flight, and
        shard s's combine is submitted as its outputs finish.  Stream
        shards always ride the flat ring (``algo`` applies to the
        barrier-path pair).  ``overlap_ticks`` is the overlap budget spent
        after each in-step submission."""
        E, D = cfg.n_experts, cfg.d_model
        assert E % n_ranks == 0, (
            f"expert-parallel layout needs n_experts % n_ranks == 0 "
            f"(E={E}, R={n_ranks})")
        self.cfg = cfg
        self.R = n_ranks
        self.epr = E // n_ranks
        self.cap = cap or _capacity(tokens_per_rank, cfg.top_k, E,
                                    cfg.capacity_factor)
        assert n_streams >= 1 and self.cap % n_streams == 0, (
            f"n_streams={n_streams} must divide the capacity "
            f"(cap={self.cap}; it is always a multiple of 4)")
        self.n_streams = n_streams
        self.overlap_ticks = overlap_ticks
        n = E * self.cap * D
        self.n_elems = n
        # The in-step waits are bounded (a missing submission must not
        # hang the step) at four ticks per slice of a rank's payload, and
        # never below the reference's 1024 ticks.
        self.wait_iters = max(1024, 4 * n // slice_elems)
        composite = hierarchy is not None or algo == "auto"
        self.occl = OcclRuntime(OcclConfig(
            n_ranks=n_ranks,
            max_colls=max(8, 2 * (1 + n_streams) + (8 if composite else 0)),
            max_comms=4 if composite else 1,
            slice_elems=slice_elems,
            conn_depth=8,
            heap_elems=max(1 << 14, 10 * n) * (2 if composite else 1),
            superstep_budget=1 << 16,
        ), device=device)
        self.device = self.occl.device
        comm = self.occl.communicator(list(range(n_ranks)))
        self.disp_id = self.occl.register(
            CollKind.ALL_TO_ALL, comm, n_elems=n, algo=algo,
            hierarchy=hierarchy)
        self.comb_id = self.occl.register(
            CollKind.ALL_TO_ALL, comm, n_elems=n, algo=algo,
            hierarchy=hierarchy)
        cap_s = self.cap // n_streams
        self.disp_stream_ids = [
            self.occl.register(CollKind.ALL_TO_ALL, comm,
                               n_elems=E * cap_s * D, algo="ring")
            for _ in range(n_streams)]
        self.comb_stream_ids = [
            self.occl.register(CollKind.ALL_TO_ALL, comm,
                               n_elems=E * cap_s * D, algo="ring")
            for _ in range(n_streams)]

    def _tokens(self, xs: Sequence) -> list:
        assert len(xs) == self.R
        return [torch.as_tensor(x, device=self.device) for x in xs]

    def forward(self, params, xs: Sequence) -> list:
        """xs: one [T_l, D] local token matrix per rank -> one [T_l, D]
        float32 output per rank, bit-comparable to :func:`ep_forward_ref`.

        Payloads go through staged submits (one batched heap flush per
        exchange); submission order across ranks is free — the runtime is
        deadlock-free by construction."""
        xs = self._tokens(xs)
        meta = []
        for r in range(self.R):
            xe, m = _dispatch_local(self.cfg, params, xs[r], self.cap)
            meta.append(m)
            self.occl.submit(r, self.disp_id, data=xe.cpu().numpy())
        self.occl.drive()
        recv = self.occl.read_outputs_bulk(
            [(r, self.disp_id) for r in range(self.R)])
        for d in range(self.R):
            got = torch.from_numpy(recv[(d, self.disp_id)]).to(self.device)
            ye = _expert_ffn(params, d, self.R, got, self.epr, self.cap,
                             self.cfg.d_model)
            self.occl.submit(d, self.comb_id, data=ye.cpu().numpy())
        self.occl.drive()
        back = self.occl.read_outputs_bulk(
            [(r, self.comb_id) for r in range(self.R)])
        return [_combine_local(
            params, xs[r],
            torch.from_numpy(back[(r, self.comb_id)]).to(self.device),
            *meta[r][1:]) for r in range(self.R)]

    # ------------------------------------------------------------------
    # overlapped path: stream-sharded dispatch/combine inside one step
    # (tick contract; core/daemon.py and core/device_api.py)
    # ------------------------------------------------------------------
    def _wait(self, api, st, cid: int, target: torch.Tensor):
        """Exposed wait until every rank completed ``cid`` ``target``
        times; raises :class:`StepTimeout` past ``wait_iters`` ticks."""
        st = api.tick_until(
            st, lambda t: (api.completed(t, cid) >= target).all(),
            chunk=WAIT_CHUNK, max_iters=self.wait_iters, barrier=True)
        if not bool((api.completed(st, cid) >= target).all()):
            raise StepTimeout(
                f"OcclMoE: dispatch shard {cid} incomplete after "
                f"{self.wait_iters} ticks of {WAIT_CHUNK} supersteps")
        return st

    def _overlap_core(self, st, params, xs: list):
        api = self.occl.device_api()
        cfg, R, S = self.cfg, self.R, self.n_streams
        cap, epr, D = self.cap, self.epr, cfg.d_model
        cap_s = cap // S
        E = cfg.n_experts
        disp_ids, comb_ids = self.disp_stream_ids, self.comb_stream_ids
        k_over = self.overlap_ticks
        st = api.step_prologue(st, ticks=(k_over, WAIT_CHUNK, TICK_CHUNK))
        base = [api.completed(st, c).clone() for c in disp_ids]
        local = [_dispatch_local_t(cfg, params, x, cap) for x in xs]
        xe = torch.stack([m[0] for m in local])         # [R, E, cap, D]
        # Submit every dispatch shard up front (rising stream priority),
        # spending a bounded overlap tick after each — later shards'
        # staging hides earlier shards' supersteps.
        for s in range(S):
            shard = xe[:, :, s * cap_s:(s + 1) * cap_s, :].reshape(R, -1)
            st = api.submit_all(st, disp_ids[s], shard, prio=s)
            st, _ = api.tick(st, k_over, barrier=False)
        for s in range(S):
            # Exposed wait: only until THIS shard's granules arrived — the
            # dispatch tails of shards > s keep flying while shard s's
            # expert FFN runs below.
            st = self._wait(api, st, disp_ids[s], base[s] + 1)
            recv = api.read_all(st, disp_ids[s])
            ys = _expert_ffn_batched(params, recv, R, epr, cap_s, D)
            # Combine submitted per shard as its outputs finish (no
            # full-layer barrier), then another hidden tick.
            st = api.submit_all(st, comb_ids[s], ys, prio=S + s)
            st, _ = api.tick(st, k_over, barrier=False)
        st = api.drain(st, max_iters=self.wait_iters)
        if not bool(_drained(st).all()):
            raise StepTimeout(
                f"OcclMoE: combine still pending after {self.wait_iters} "
                f"drain ticks of {TICK_CHUNK} supersteps")
        back = torch.cat(
            [api.read_all(st, comb_ids[s]).reshape(R, E, cap_s, D)
             for s in range(S)], dim=2)                   # [R, E, cap, D]
        y = [_combine_local(params, xs[r], back[r].reshape(-1),
                            local[r][2], local[r][3]) for r in range(R)]
        return st, y

    def forward_overlapped(self, params, xs: Sequence) -> list:
        """The overlap-mode :meth:`forward`: dispatch -> per-shard (wait,
        FFN, combine-submit) -> drain in one step on the device API, with
        daemon ticks interleaved so only the per-shard arrival waits and
        the final drain are EXPOSED supersteps (``stats()``'s barrier /
        overlap split measures it).  Matches :func:`ep_forward_ref` to
        float32 rounding: the batched expert product may sum in another
        order than the per-rank one."""
        st, y = self._overlap_core(self.occl.state, params,
                                   self._tokens(xs))
        self.occl.adopt_state(st)
        return y

    def stats(self):
        return self.occl.stats()
