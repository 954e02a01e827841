"""Host-side SQ/CQ handling (paper Sec. 3.1.2).

Submission-queue entries carry the collective id, user priority and live
buffer addresses (heap offsets) — the dynamic part of the static context.
The completion queue is drained by a poller that dispatches user callbacks
registered in the callback map at submission time.

PyTorch port of ``repro.core.sqcq``.  The rings cross the host/device
boundary at daemon (re)launches — the paper's voluntary-quit /
event-driven-restart cycle (Sec. 3.1.3) supplies exactly that boundary:
``pack_sq`` ships one launch's SQEs to the device, ``reconcile`` reads the
completion counters back.

The same boundary carries the submit-time STAGING queue: payloads passed
to ``OcclRuntime.submit(..., data=...)`` are parked here host-side (one
entry per (rank, collective); a re-submission before the flush supersedes
the earlier payload, matching the old immediate-write semantics) and
drained by the launch prologue into one batched device scatter
(staging.StagingEngine) instead of a per-call device round trip.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .config import OcclConfig
from .state import DaemonState


@dataclasses.dataclass
class SQE:
    coll_id: int
    prio: int = 0
    in_off: int = -1    # -1 = keep the registered default
    out_off: int = -1
    callback: Optional[Callable[[int, int], None]] = None  # (rank, coll_id)


class HostQueues:
    """Per-rank pending submissions + callback map + completion counters."""

    def __init__(self, cfg: OcclConfig):
        self.cfg = cfg
        self.pending: list[collections.deque[SQE]] = [
            collections.deque() for _ in range(cfg.n_ranks)
        ]
        self.callbacks: list[dict[int, collections.deque]] = [
            collections.defaultdict(collections.deque)
            for _ in range(cfg.n_ranks)
        ]
        self.submitted = np.zeros(cfg.n_ranks, np.int64)
        self.completed = np.zeros(cfg.n_ranks, np.int64)
        # Submit-time staged payloads: {(rank, coll_id, in_off): data},
        # drained once per daemon launch by OcclRuntime._flush_staged.
        # The offset is part of the key: two pre-flush submissions of the
        # same collective at DIFFERENT dynamic offsets are distinct
        # executions and both payloads must reach the heap; only a
        # re-submission at the same offset supersedes (the old
        # immediate-write last-write-wins semantics).
        self.staged: dict = {}
        # Relaunch bookkeeping: reconcile() is called once per daemon
        # launch; ``launch_completions`` holds the completions each recent
        # launch contributed (bounded window — long-lived runtimes
        # relaunch indefinitely) and ``reconciles`` the total launch count
        # (host-side mirror of the device's epoch counter, useful for
        # spotting one-superstep launches).
        self.reconciles = 0
        self.launch_completions: collections.deque = collections.deque(
            maxlen=1024)
        # Last-seen snapshot of the device's cumulative per-(rank, coll)
        # completion counters; reconcile() consumes the delta, so every
        # completion is accounted even when the CQ ring wraps more than
        # once within a single launch.
        self._completed_seen = np.zeros(
            (cfg.n_ranks, cfg.max_colls), np.int64)

    def submit(self, rank: int, sqe: SQE, cb_coll: Optional[int] = None
               ) -> None:
        """``cb_coll`` keys the callback under a different collective id
        than the submitted SQE — the runtime passes a composite chain's
        TAIL here, because that is the id the device CQE will carry."""
        self.pending[rank].append(sqe)
        if sqe.callback is not None:
            self.callbacks[rank][
                sqe.coll_id if cb_coll is None else cb_coll
            ].append(sqe.callback)
        self.submitted[rank] += 1

    # -- submit-time payload staging --------------------------------------
    def stage(self, rank: int, coll_id: int, data, in_off: int) -> None:
        """Park a payload for the next launch-prologue flush (last write
        per (rank, collective, offset) wins, like the old immediate-write
        path; distinct offsets are distinct buffers and coexist)."""
        self.staged[(rank, coll_id, in_off)] = data

    def take_staged(self) -> list:
        """Drain the staging queue as ``(rank, coll_id, data, in_off)``
        items for one batched StagingEngine.write."""
        items = [(rank, cid, data, off)
                 for (rank, cid, off), data in self.staged.items()]
        self.staged.clear()
        return items

    # -- device-bound packing ---------------------------------------------
    def pack_sq(self, st: DaemonState) -> DaemonState:
        """Load up to sq_len pending SQEs per rank into the state's SQ and
        reset the cursors (the previous launch's consumed entries were
        already popped by :meth:`reconcile`)."""
        cfg = self.cfg
        sq_coll = np.full((cfg.n_ranks, cfg.sq_len), -1, np.int32)
        sq_prio = np.zeros((cfg.n_ranks, cfg.sq_len), np.int32)
        sq_in = np.full((cfg.n_ranks, cfg.sq_len), -1, np.int32)
        sq_out = np.full((cfg.n_ranks, cfg.sq_len), -1, np.int32)
        sq_size = np.zeros((cfg.n_ranks,), np.int32)
        for r in range(cfg.n_ranks):
            n = min(len(self.pending[r]), cfg.sq_len)
            for i in range(n):
                e = self.pending[r][i]
                sq_coll[r, i] = e.coll_id
                sq_prio[r, i] = e.prio
                sq_in[r, i] = e.in_off
                sq_out[r, i] = e.out_off
            sq_size[r] = n
        dev = st.sq_coll.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        return st._replace(
            sq_coll=put(sq_coll), sq_prio=put(sq_prio),
            sq_in=put(sq_in), sq_out=put(sq_out),
            sq_size=put(sq_size),
            sq_read=torch.zeros((cfg.n_ranks,), dtype=torch.int32,
                                device=dev),
            cq_coll=torch.full((cfg.n_ranks, cfg.cq_len), -1,
                               dtype=torch.int32, device=dev),
            cq_count=torch.zeros((cfg.n_ranks,), dtype=torch.int32,
                                 device=dev),
        )

    # -- post-launch reconciliation ----------------------------------------
    def reconcile(self, st: DaemonState) -> int:
        """Pop consumed SQEs, account completions, fire callbacks.

        Completion accounting is driven by the device's cumulative
        ``completed`` matrix rather than by walking CQEs: the device CQ is
        a RING (slots wrap modulo ``cq_len``), so with more than ``cq_len``
        completions per launch early CQEs are rotated out — the counter
        delta still reconciles every one of them exactly.  Returns the
        number of completions accounted this call.
        """
        cfg = self.cfg
        # One device->host transfer for the four counters.
        R = cfg.n_ranks
        host = torch.cat([st.sq_read[:, None], st.cq_count[:, None],
                          st.completed, st.cq_coll], dim=1).cpu().numpy()
        sq_read, cq_count = host[:, 0], host[:, 1]
        comp = host[:, 2:2 + cfg.max_colls].astype(np.int64)  # cumulative
        cq_coll = host[:, 2 + cfg.max_colls:]
        assert cq_coll.shape == (R, cfg.cq_len)
        fired = 0
        for r in range(cfg.n_ranks):
            for _ in range(int(sq_read[r])):
                self.pending[r].popleft()
            delta = comp[r] - self._completed_seen[r]
            # Surviving ring entries, oldest first (completion order).
            cqc = int(cq_count[r])
            ring = [int(cq_coll[r, i % cfg.cq_len])
                    for i in range(max(0, cqc - cfg.cq_len), cqc)]
            # Completions rotated out of a wrapped ring: exact counts from
            # the counter delta, completion order unrecoverable.
            lost = delta.copy()
            for c in ring:
                lost[c] -= 1
            seq = list(np.repeat(np.arange(cfg.max_colls),
                                 np.maximum(lost, 0))) + ring
            for c in seq:
                self.completed[r] += 1
                fired += 1
                cbs = self.callbacks[r].get(int(c))
                if cbs:
                    cbs.popleft()(r, int(c))
            self._completed_seen[r] = comp[r]
        self.reconciles += 1
        self.launch_completions.append(fired)
        return fired

    def outstanding(self) -> int:
        """#SQEs submitted whose CQE has not been seen (drives relaunch)."""
        return int(self.submitted.sum() - self.completed.sum())
