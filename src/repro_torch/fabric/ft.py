"""Fault tolerance over one port runtime: detection -> diagnosis -> eviction.

PyTorch port of the ``ReliabilityController`` of ``repro.fabric.ft``.  The
reference module's ``TrainController`` (checkpoint/restart around a train
loop) needs the port's ``checkpoint/`` and ``data/`` packages, which are
not ported yet (ROADMAP.md, "Modules to port", item 8); it raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import warnings

from ..core.errors import DeadlockTimeout, StepTimeout
from ..core.recorder import diagnose
from .straggler import StragglerDetector

__all__ = ["ReliabilityController", "StepTimeout", "TrainController"]


class TrainController:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TrainController is not ported yet (ROADMAP.md, 'Modules to "
            "port', item 8: model/training substrate)")


class ReliabilityController:
    """Detection -> diagnosis -> eviction glue over one OcclRuntime.

    The reliability loop a fleet controller runs around the training
    step:

    1. **observe**: feed per-rank step times and the runtime's per-rank
       superstep/RTC stats into the :class:`StragglerDetector` (both
       channels — wall-clock alone misses a rank that is healthy
       host-side but wedging the fabric);
    2. **diagnose**: on a :class:`DeadlockTimeout` (or on demand) run
       ``recorder.diagnose`` and mark every named holder suspect;
    3. **heal**: evict every rank outside ``healthy_ranks()`` (highest
       rank first, so earlier evictions do not renumber later ones) and
       resume — ``evict()`` replays the wedged submissions, so surviving
       ranks' in-flight work completes on the shrunk fabric.  The
       eviction list is capped so at least ``min_survivors`` ranks stay
       (a detector that flags the whole fleet — e.g. diagnose naming
       every member of a stalled chain — must not tear the job down
       mid-heal); the capped remainder is reported in ``deferred``.
    """

    def __init__(self, runtime, detector: StragglerDetector | None = None,
                 min_survivors: int = 1, tenant_namer=None):
        self.runtime = runtime
        self.detector = detector or StragglerDetector(runtime.cfg.n_ranks)
        self.evicted: list[int] = []    # ranks as numbered at eviction time
        self.min_survivors = max(1, min_survivors)
        self.deferred: list[int] = []   # suspects kept alive by the cap
        # Optional coll_id -> tenant-label map (serving QoS: the fabric
        # is multi-tenant, and a diagnosis that names "collective 3"
        # without saying WHICH traffic class owns it sends the operator
        # back to the registration log).
        self.tenant_namer = tenant_namer

    @classmethod
    def for_serving(cls, qos, detector: StragglerDetector | None = None,
                    min_survivors: int = 1) -> "ReliabilityController":
        """Bind the reliability loop to a serving QoS fabric
        (a serving QoS object exposing ``runtime`` and ``class_of``, as
        ``repro.serving.qos.ServingQos`` does): the decode tenant's
        rtc-latency feeds the same collective EWMA channel as training
        collectives, and diagnosis names stalled chains BY tenant — a
        wedged background burst is reported as BACKGROUND holding the
        lane instead of silently inflating decode p99."""
        return cls(qos.runtime, detector=detector,
                   min_survivors=min_survivors, tenant_namer=qos.class_of)

    def observe_step(self, step_times_s=None) -> None:
        """One observation window: optional per-rank wall-clock times
        (``{rank: seconds}``) plus the runtime's current collective
        stats.  On a serving fabric the stats include the decode
        tenant's per-rank rtc latency, so a rank dragging decode feeds
        the same EWMA channel as one dragging grad-sync."""
        if step_times_s:
            for r, t in step_times_s.items():
                self.detector.observe(r, t)
        self.detector.observe_collective_stats(self.runtime.stats())

    def diagnose_tenants(self) -> list[dict]:
        """Current stalled chains annotated with their tenant label
        (``tenant_namer``; None for unmapped collectives) — the
        serving-facing diagnosis surface."""
        out = []
        for s in diagnose(self.runtime).stalled:
            out.append({
                "coll_id": int(s.coll_id),
                "tenant": (self.tenant_namer(s.coll_id)
                           if self.tenant_namer else None),
                "holding_ranks": list(s.holding_ranks),
                "waiting_ranks": list(s.waiting_ranks),
                "reason": s.reason,
            })
        return out

    def heal(self, error: DeadlockTimeout | None = None) -> list[int]:
        """Mark diagnosed holders suspect, evict every unhealthy rank and
        resume.  Returns the evicted ranks (pre-eviction numbering).
        With no ``error``, diagnoses the runtime's current outstanding
        set directly (no-op when nothing is stalled).  Evictions are
        capped to keep ``min_survivors`` ranks; suspects spared by the
        cap land in ``self.deferred`` (with a warning) instead of
        raising :class:`~repro_torch.core.errors.EvictionError` mid-loop."""
        diag = error.diagnosis if error is not None and \
            error.diagnosis is not None else diagnose(self.runtime)
        for r in diag.holders:
            self.detector.mark_suspect(r)
        healthy = set(self.detector.healthy_ranks())
        R = self.runtime.cfg.n_ranks
        bad = sorted((r for r in range(R) if r not in healthy),
                     reverse=True)
        # Floor: never evict past min_survivors ranks — a detector that
        # flags (almost) everyone would otherwise hit EvictionError
        # MID-loop with some evictions already applied.  Highest-numbered
        # suspects go first (stable renumbering); the rest are deferred,
        # not evicted, and reported for the controller's next window.
        max_evict = max(0, R - self.min_survivors)
        self.deferred = sorted(bad[max_evict:])
        bad = bad[:max_evict]
        if self.deferred:
            warnings.warn(
                f"heal(): {len(bad) + len(self.deferred)} of {R} ranks "
                f"flagged unhealthy; evicting {len(bad)} and keeping "
                f"suspect rank(s) {self.deferred} alive to preserve "
                f"{self.min_survivors} survivor(s)", stacklevel=2)
        for r in bad:
            self.runtime.evict(r)
        if bad:
            self.evicted.extend(bad)
            # Rank numbering changed; timing history no longer maps onto
            # rank ids — restart the detector for the shrunk fleet.
            self.detector = StragglerDetector(
                self.runtime.cfg.n_ranks, alpha=self.detector.alpha,
                threshold=self.detector.threshold)
        return bad
