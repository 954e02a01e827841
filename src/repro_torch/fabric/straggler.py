"""Step-level straggler detection (PyTorch port of
``repro.fabric.straggler``; numpy only, no device work).

Collective-layer straggler tolerance is intrinsic to OCCL (bounded
supersteps + voluntary quit: a slow rank only delays its own collectives,
which get preempted rather than wedging peers).  This module adds the
fleet-level detector with THREE signals feeding one exclusion list:

* wall-clock: per-rank step-time EWMAs (``observe``) flag ranks whose
  times exceed ``threshold`` x the fleet median;
* collective latency: ``observe_collective_stats`` ingests the runtime's
  per-rank ready-to-complete superstep counters (``rtc_latency`` /
  ``rtc_events`` from ``OcclRuntime.stats()``) — a rank whose mean RTC
  latency EWMA exceeds ``threshold`` x the median is dragging the fabric
  even when its host-side step times look normal, and a rank whose event
  counter stops advancing while the fleet's median does is wedged;
* explicit suspicion: ``mark_suspect`` pins a rank (the hang-diagnosis
  path — ``recorder.diagnose`` names the holder of a stalled chain and
  the controller marks it here before evicting).

``healthy_ranks()`` is the controller-facing output: every rank not
flagged by any signal; ``fabric.ft.ReliabilityController`` drives
``OcclRuntime.evict()`` from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    n_ranks: int
    alpha: float = 0.3          # EWMA factor
    threshold: float = 2.0      # x median -> straggler

    def __post_init__(self):
        self.ewma = np.zeros(self.n_ranks)
        self.seen = np.zeros(self.n_ranks, dtype=bool)
        # Collective-latency channel (superstep units, separate EWMA —
        # never mixed with the wall-clock seconds channel above).
        self.coll_ewma = np.zeros(self.n_ranks)
        self.coll_seen = np.zeros(self.n_ranks, dtype=bool)
        self.suspect = np.zeros(self.n_ranks, dtype=bool)
        # Cumulative-counter snapshots (stats() counters are monotonic;
        # deltas between observe calls are the per-window signal).
        self._last_lat = np.zeros(self.n_ranks)
        self._last_ev = np.zeros(self.n_ranks)

    def observe(self, rank: int, step_time_s: float):
        if not self.seen[rank]:
            self.ewma[rank] = step_time_s
            self.seen[rank] = True
        else:
            self.ewma[rank] = (self.alpha * step_time_s
                               + (1 - self.alpha) * self.ewma[rank])

    def observe_collective_stats(self, stats: dict):
        """Ingest ``OcclRuntime.stats()``: per-rank mean ready-to-complete
        latency over the window since the previous call feeds the
        collective EWMA; a rank completing NOTHING while the fleet's
        median completion count advances is marked suspect (wedged)."""
        lat = np.asarray(stats["rtc_latency"], dtype=float).sum(axis=1)
        ev = np.asarray(stats["rtc_events"], dtype=float).sum(axis=1)
        n = min(self.n_ranks, lat.shape[0])
        d_lat = lat[:n] - self._last_lat[:n]
        d_ev = ev[:n] - self._last_ev[:n]
        self._last_lat[:n] = lat[:n]
        self._last_ev[:n] = ev[:n]
        for r in range(n):
            if d_ev[r] > 0:
                mean = d_lat[r] / d_ev[r]
                if not self.coll_seen[r]:
                    self.coll_ewma[r] = mean
                    self.coll_seen[r] = True
                else:
                    self.coll_ewma[r] = (self.alpha * mean
                                         + (1 - self.alpha)
                                         * self.coll_ewma[r])
        if float(np.median(d_ev[:n])) > 0:
            for r in range(n):
                if d_ev[r] == 0:
                    self.suspect[r] = True

    def mark_suspect(self, rank: int):
        """Pin a rank as unhealthy regardless of its timing EWMAs — the
        hang-diagnosis path (``recorder.diagnose`` named it as holding a
        stalled chain)."""
        self.suspect[rank] = True

    def _over_median(self, ewma: np.ndarray, seen: np.ndarray) -> list[int]:
        if not seen.any():
            return []
        med = float(np.median(ewma[seen]))
        if med <= 0:
            return []
        return [r for r in range(self.n_ranks)
                if seen[r] and ewma[r] > self.threshold * med]

    def stragglers(self) -> list[int]:
        """Ranks flagged by ANY signal: wall-clock EWMA, collective RTC
        latency EWMA, or explicit suspicion."""
        bad = set(self._over_median(self.ewma, self.seen))
        bad |= set(self._over_median(self.coll_ewma, self.coll_seen))
        bad |= {r for r in range(self.n_ranks) if self.suspect[r]}
        return sorted(bad)

    def healthy_ranks(self) -> list[int]:
        bad = set(self.stragglers())
        return [r for r in range(self.n_ranks) if r not in bad]
