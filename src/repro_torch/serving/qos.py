"""Serving QoS: traffic-class tenants sharing one OCCL fabric.

PyTorch port of ``repro.serving.qos``.  The paper's bottom-level
preemption exists in this repo as a deadlock-prevention tool; this module
turns it into a tail-latency optimization.
Three traffic classes map onto the scheduler's priority strides
(config.QUEUE_KEY_PRIO_STRIDE), separated by one CLASS_STRIDE each so
intra-class offsets can never bleed across classes:

* ``DECODE``   — the per-decode-step tensor-parallel all-reduce.  The
  latency-critical op: every generated token blocks on it.
* ``PREFILL``  — the prompt-ingest all-gather (larger, less critical).
* ``BACKGROUND`` — grad-sync buckets and checkpoint broadcasts: big
  throughput bursts that must not sit in front of a decode step.

With ``preemption=True`` the fabric runs ``OrderPolicy.PRIORITY`` +
``priority_preempts``: a decode submit landing mid-background-burst
preempts the in-flight bucket at slice granularity (the paper's
mechanism) instead of waiting out the whole transfer.  With
``preemption=False`` the same traffic runs FIFO at equal priority — the
no-QoS baseline the serving bench compares against.

Starvation bound: ``prio_aging_quantum`` (core/config.py) gives every
queued collective ``min(age // quantum, cap)`` extra effective priority
on the launch clock.  The cap defaults to one class stride, so an aged
BACKGROUND bucket overtakes queued PREFILLs after a bounded wait but
never outranks DECODE; DECODE itself is open-loop (arrival gaps), so
background drains in the gaps — ``drain()`` proves it after every
replay.

The fabric is driven by bounded DeviceApi ticks (``advance``): staged
submits are flushed and packed, the daemon auto-relaunches when it went
not-live with work pending, and completion callbacks stamp the replay
clock — latency is measured in SUPERSTEPS (structural, noise-immune),
with wall-clock modeled from a measured superstep cost.  A tick of ``k``
supersteps replays one CUDA graph on the card
(:class:`~repro_torch.core.daemon.SimTicker`); the callbacks fire in the
reference's order (``HostQueues.reconcile``), so the per-class latencies
equal the reference's on the same traffic.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from ..core.config import OcclConfig, OrderPolicy
from ..core.primitives import CollKind
from ..core.recorder import diagnose
from ..core.runtime import OcclRuntime


class TrafficClass(enum.IntEnum):
    """Serving traffic classes, low to high priority."""

    BACKGROUND = 0
    PREFILL = 1
    DECODE = 2


# Priority distance between adjacent classes.  Base priorities are
# ``cls * CLASS_STRIDE``; per-submit offsets live inside [0, CLASS_STRIDE)
# so classes cannot bleed into each other, and the default aging cap
# (2 * CLASS_STRIDE - 1 = 255) lets a starved tenant age past exactly
# ONE class boundary: BACKGROUND (base 0) tops out at 255, under
# DECODE's 256.  Worst-case effective priority stays inside the
# scheduler's +/-512 clip band (the clip re-asserts it regardless).
CLASS_STRIDE = 128
AGING_CAP = 2 * CLASS_STRIDE - 1


def class_prio(cls: TrafficClass, offset: int = 0) -> int:
    """Scheduler priority for a traffic class (+ bounded intra-class
    offset)."""
    if not 0 <= offset < CLASS_STRIDE:
        raise ValueError(
            f"intra-class offset {offset} outside [0, {CLASS_STRIDE})")
    return int(cls) * CLASS_STRIDE + offset


@dataclasses.dataclass
class TenantStats:
    """Per-class submit/complete accounting + latency samples."""

    submitted: int = 0
    completed: int = 0
    latencies: list = dataclasses.field(default_factory=list)  # supersteps

    def percentile(self, q: float) -> float:
        if not self.latencies:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies, float), q))


class ServingQos:
    """One shared fabric, three tenants, per-class submit wrappers.

    All tenants register on a SINGLE communicator lane — contention is
    the point: preemption only matters when decode and background fight
    over the same connector.  ``preemption`` toggles the whole QoS
    mechanism (PRIORITY + priority_preempts + aging vs flat FIFO) so a
    bench can compare the two regimes on identical traffic.
    """

    def __init__(self, n_ranks: int = 4, *, decode_elems: int = 256,
                 prefill_elems: int = 1024, background_elems: int = 4096,
                 background_buckets: int = 2, ckpt_elems: int = 512,
                 preemption: bool = True, max_background_inflight: int = 2,
                 prio_aging_quantum: int = 0,
                 prio_aging_cap: int = AGING_CAP,
                 tick_chunk: int = 1, slice_elems: int = 64,
                 conn_depth: int = 4, burst_slices: int = 1,
                 quit_threshold: int = 64, superstep_budget: int = 4096,
                 heap_elems: int = 1 << 17, flight_recorder: bool = True,
                 device=None):
        """``device``: where the fabric lives (``None``: ``cuda``, raising
        without a card)."""
        self.preemption = bool(preemption)
        self.tick_chunk = int(tick_chunk)
        self.max_background_inflight = int(max_background_inflight)
        self.cfg = OcclConfig(
            n_ranks=n_ranks, max_colls=max(8, background_buckets + 6),
            max_comms=1, slice_elems=slice_elems, conn_depth=conn_depth,
            burst_slices=burst_slices, heap_elems=heap_elems,
            order_policy=(OrderPolicy.PRIORITY if self.preemption
                          else OrderPolicy.FIFO),
            priority_preempts=self.preemption,
            prio_aging_quantum=(prio_aging_quantum if self.preemption
                                else 0),
            prio_aging_cap=prio_aging_cap,
            quit_threshold=quit_threshold,
            superstep_budget=superstep_budget,
            flight_recorder=flight_recorder)
        self.runtime = OcclRuntime(self.cfg, device=device)
        comm = self.runtime.communicator(list(range(n_ranks)))
        self.decode = self.runtime.register(
            CollKind.ALL_REDUCE, comm, n_elems=decode_elems)
        self.prefill = self.runtime.register(
            CollKind.ALL_GATHER, comm, n_elems=prefill_elems)
        self.background = [
            self.runtime.register(CollKind.ALL_REDUCE, comm,
                                  n_elems=background_elems)
            for _ in range(background_buckets)]
        self.ckpt = self.runtime.register(
            CollKind.BROADCAST, comm, n_elems=ckpt_elems)
        self._class_of = {int(self.decode): TrafficClass.DECODE,
                          int(self.prefill): TrafficClass.PREFILL,
                          int(self.ckpt): TrafficClass.BACKGROUND}
        for h in self.background:
            self._class_of[int(h)] = TrafficClass.BACKGROUND
        self.tenants = {cls: TenantStats() for cls in TrafficClass}
        self._inflight = {cls: 0 for cls in TrafficClass}
        self._bg_rr = 0
        self.now = 0                    # replay superstep clock

    # ------------------------------------------------------------------
    # fabric driving (bounded DeviceApi ticks)
    # ------------------------------------------------------------------
    def advance(self, k: Optional[int] = None) -> None:
        """Advance the shared fabric (and the replay clock) by ``k``
        supersteps.  An idle fabric fast-forwards the clock without
        ticking — open-loop arrival gaps cost no device work."""
        k = self.tick_chunk if k is None else int(k)
        rt = self.runtime
        if rt.queues.outstanding() == 0:
            self.now += k
            return
        rt._flush_staged()
        st = rt.queues.pack_sq(rt._state)
        st, _ = rt.device_api().tick(st, k, barrier=True)
        rt._state = st
        rt.queues.reconcile(st)
        self.now += k

    def drain(self, patience: int = 2048) -> int:
        """Advance until every outstanding submission completed; returns
        the supersteps spent.  ``patience`` bounds consecutive no-
        completion advances so a wedged tenant raises the enriched
        DeadlockTimeout (flight record + diagnosis) instead of hanging."""
        rt = self.runtime
        start, idle = self.now, 0
        while rt.queues.outstanding():
            before = int(rt.queues.completed.sum())
            self.advance()
            idle = idle + 1 if int(rt.queues.completed.sum()) == before \
                else 0
            if idle >= patience:
                raise rt._deadlock_error(
                    f"{rt.queues.outstanding()} serving submissions "
                    f"outstanding after {idle} advances without a "
                    "completion — a tenant is wedged")
        return self.now - start

    # ------------------------------------------------------------------
    # per-class submit wrappers
    # ------------------------------------------------------------------
    def _submit(self, cls: TrafficClass, handle, data=None,
                offset: int = 0) -> dict:
        """Submit one collective on all ranks under its class priority;
        returns a pending record whose ``done_at`` is stamped (replay
        clock) when the LAST rank's CQE reconciles."""
        prio = class_prio(cls, offset) if self.preemption else 0
        rec = {"class": cls, "cid": int(handle), "arrival": self.now,
               "done_at": None}
        stats = self.tenants[cls]
        stats.submitted += 1
        self._inflight[cls] += 1
        remaining = [self.cfg.n_ranks]

        def _cb(rank, cid, _rec=rec, _stats=stats, _left=remaining,
                _cls=cls):
            _left[0] -= 1
            if _left[0] == 0:
                _rec["done_at"] = self.now
                _stats.completed += 1
                _stats.latencies.append(self.now - _rec["arrival"])
                self._inflight[_cls] -= 1

        self.runtime.submit_all(handle, prio=prio, data=data, callback=_cb)
        return rec

    def submit_decode(self, data=None) -> dict:
        return self._submit(TrafficClass.DECODE, self.decode, data=data)

    def submit_prefill(self, data=None) -> dict:
        return self._submit(TrafficClass.PREFILL, self.prefill, data=data)

    def admit_background(self) -> bool:
        """Preemption-aware admission: background joins the lane only
        while its inflight bursts sit under the cap — the cheap first
        line of defense before preemption has to cut a transfer."""
        return self._inflight[TrafficClass.BACKGROUND] \
            < self.max_background_inflight

    def submit_background(self) -> Optional[dict]:
        """Admission-gated round-robin grad-sync bucket submit; None
        when the inflight cap holds the burst back."""
        if not self.admit_background():
            return None
        h = self.background[self._bg_rr % len(self.background)]
        self._bg_rr += 1
        return self._submit(TrafficClass.BACKGROUND, h)

    def submit_checkpoint(self) -> Optional[dict]:
        if not self.admit_background():
            return None
        return self._submit(TrafficClass.BACKGROUND, self.ckpt)

    def pump_background(self) -> int:
        """Adversarial background tenant: refill grad-sync bursts up to
        the admission cap.  Returns how many were admitted."""
        n = 0
        while self.submit_background() is not None:
            n += 1
        return n

    def wait(self, rec: dict, max_supersteps: int = 1 << 16) -> int:
        """Advance until ``rec`` completes; returns its latency in
        supersteps (replay clock)."""
        start = self.now
        while rec["done_at"] is None:
            if self.now - start > max_supersteps:
                raise self.runtime._deadlock_error(
                    f"{rec['class'].name} submission incomplete after "
                    f"{self.now - start} supersteps")
            self.advance()
        return rec["done_at"] - rec["arrival"]

    # ------------------------------------------------------------------
    # event hooks for ServingEngine (one decode step / one prefill)
    # ------------------------------------------------------------------
    def decode_event(self, pump: bool = True) -> int:
        """One decode step's TP all-reduce: submit, (optionally) let the
        background tenant refill its bursts, block to completion.
        Returns the step's collective latency in supersteps."""
        rec = self.submit_decode()
        if pump:
            self.pump_background()
        return self.wait(rec)

    def prefill_event(self, pump: bool = True) -> int:
        rec = self.submit_prefill()
        if pump:
            self.pump_background()
        return self.wait(rec)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def class_of(self, coll_id: int) -> Optional[str]:
        """Tenant label of a collective id (chain stages resolve to
        their logical head's class when registered here)."""
        cls = self._class_of.get(int(coll_id))
        return cls.name if cls is not None else None

    def diagnose(self) -> list[dict]:
        """Name every stalled chain WITH its tenant: the wedged-
        background story surfaces as a named traffic class instead of
        silently inflating decode p99."""
        out = []
        for s in diagnose(self.runtime).stalled:
            out.append({"coll_id": s.coll_id,
                        "tenant": self.class_of(s.coll_id),
                        "holding_ranks": list(s.holding_ranks),
                        "waiting_ranks": list(s.waiting_ranks),
                        "reason": s.reason})
        return out

    def summary(self) -> dict:
        """Per-class latency digest (supersteps) + fabric counters."""
        st = self.runtime.stats()
        out = {"preemption": self.preemption,
               "supersteps": int(np.asarray(st["supersteps"]).max()),
               "preempts": int(np.asarray(st["preempts"]).sum())}
        for cls, t in self.tenants.items():
            out[cls.name.lower()] = {
                "submitted": t.submitted, "completed": t.completed,
                "p50": t.percentile(50), "p99": t.percentile(99),
                "mean": (float(np.mean(t.latencies))
                         if t.latencies else float("nan")),
            }
        return out
