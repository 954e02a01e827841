"""Fault tolerance: the checkpoint/restart training controller, and
detection -> diagnosis -> eviction over one port runtime.

PyTorch port of ``repro.fabric.ft``.  ``TrainController`` wraps the train
loop with:

* periodic async checkpoints (``checkpoint/ckpt.py``; the step never
  blocks on disk);
* a step watchdog (a step longer than ``step_timeout_s`` raises
  :class:`StepTimeout`, which the loop treats as a failure);
* crash recovery: on a step failure the controller restores the last
  committed checkpoint (parameters, optimizer moments and the data
  cursor) and resumes, losing at most ``ckpt_period`` steps, within
  ``max_restarts``;
* the failure-injection hook for tests (``inject_failure_at``).

One deliberate difference: recovery first waits for a save in flight,
so the step it restores is the last one the loop checkpointed (the
reference reads the directory at once and restores an older step while
that save is still being written).  The step is timed on the host clock
and ends with a synchronize on the state's device (the reference's
``block_until_ready``).

``ReliabilityController`` is the reliability loop a fleet controller runs
around the training step (its docstring).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional

import torch

from ..checkpoint.ckpt import AsyncCheckpointer, latest_step, restore
from ..core.errors import DeadlockTimeout, StepTimeout
from ..core.recorder import diagnose
from ..data.pipeline import SyntheticPipeline
from .straggler import StragglerDetector

__all__ = ["FTConfig", "ReliabilityController", "StepTimeout",
           "TrainController"]


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_period: int = 20
    keep: int = 2
    step_timeout_s: float = 300.0
    max_restarts: int = 3


class TrainController:
    def __init__(self, cfg: FTConfig, step_fn: Callable, state,
                 pipeline: SyntheticPipeline,
                 inject_failure_at: Optional[int] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.inject_failure_at = inject_failure_at
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def _checkpoint(self, step: int):
        self.ckpt.save_async(step, self.state,
                             extras={"pipeline": self.pipeline.state_dict()})

    def _recover(self):
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted")
        self.ckpt.wait()
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            raise RuntimeError("no checkpoint to recover from")
        self.state, extras = restore(self.cfg.ckpt_dir, last, self.state)
        self.pipeline.load_state_dict(extras["pipeline"])
        return last

    def run(self, n_steps: int) -> list[dict]:
        self._checkpoint(int(self.state.step))   # step-0 baseline
        self.ckpt.wait()
        done = int(self.state.step)
        while done < n_steps:
            try:
                if (self.inject_failure_at is not None
                        and done == self.inject_failure_at):
                    self.inject_failure_at = None   # fire once
                    raise RuntimeError("injected node failure")
                batch = next(self.pipeline)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                if self.state.step.device.type == "cuda":
                    torch.cuda.synchronize(self.state.step.device)
                dt = time.perf_counter() - t0
                if dt > self.cfg.step_timeout_s:
                    raise StepTimeout(f"step took {dt:.1f}s")
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics.update(step=done, step_time_s=dt,
                               restarts=self.restarts)
                self.metrics_log.append(metrics)
                done += 1
                if done % self.cfg.ckpt_period == 0:
                    self._checkpoint(done)
            except (RuntimeError, StepTimeout):
                recovered = self._recover()
                done = recovered
        self.ckpt.wait()
        self._checkpoint(done)
        self.ckpt.wait()
        return self.metrics_log


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
