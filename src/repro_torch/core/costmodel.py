"""Measured alpha-beta-gamma cost model for ``algo="auto"``.

PyTorch port of ``repro.core.costmodel`` (numpy only).  Selection is a
fitted linear model over three structural features any CompositePlan
exposes at registration time:

``predicted_wall = α · supersteps + β · bytes_on_wire + γ · n_stages``

* **supersteps** — Σ over stages of ``program_len · rounds ·
  ceil(slices_per_step / lane_cap)``: the latency term, aware of the
  per-lane burst caps of the bandwidth-skew knob (cfg.bandwidth_groups),
  so a flat ring whose single lane crosses island boundaries is charged
  the slow inter cap on EVERY step while a hierarchical plan pays it only
  on its inter stages.
* **bytes_on_wire** — Σ over stages of per-rank payload bytes forwarded
  per lane (``program_len · rounds · slices · slice_elems · itemsize``).
* **n_stages** — the per-stage overhead term (successor enqueue, relink,
  extra program dispatch).

(α, β, γ) are fitted to plans timed on the card: ``chip_smoke.py`` times
the algos sweep of ``BENCH_collectives.json`` (R=16, grid (4, 4), 256 and
16384 elements, bandwidth skew 4 islands / inter cap 2) with the port's
graph-replayed daemon and fits it with :func:`fit`; the fit is kept in
``BENCH_torch_calibration.json`` at the repository root together with the
card's name and power limit.  The reference's ``BENCH_calibration.json``
holds CPU seconds of the JAX sim and is never read here.  With no
calibration file :meth:`CostModel.default` is used (α = 1 superstep unit,
β = 0, γ = 24 superstep-equivalents per stage).  ``REPRO_TORCH_CALIBRATION``
names another file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .primitives import CollKind, derive_slicing, program_len
from .tables import _WIRE_ITEMSIZE

# Default location: the repository root (costmodel.py lives at
# src/repro_torch/core/).  REPRO_TORCH_CALIBRATION overrides it.
CALIBRATION_JSON = (Path(__file__).resolve().parents[3]
                    / "BENCH_torch_calibration.json")


def _calibration_path(path=None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get("REPRO_TORCH_CALIBRATION")
    return Path(env) if env else CALIBRATION_JSON


@dataclasses.dataclass(frozen=True)
class CostModel:
    """A fitted (α, β, γ) triple; ``source`` records provenance."""

    alpha: float = 1.0          # per superstep
    beta: float = 0.0           # per wire byte
    gamma: float = 24.0         # per chain stage
    source: str = "default"

    def predict(self, features: dict) -> float:
        """Predicted wall-clock (model units) of one plan's features."""
        return (self.alpha * features["supersteps"]
                + self.beta * features["bytes"]
                + self.gamma * features["stages"])

    @classmethod
    def default(cls) -> "CostModel":
        return cls()

    @classmethod
    def load(cls, path=None, backend: str = "sim") -> "CostModel":
        """Load the persisted per-backend fit; default() when absent or
        unreadable (auto selection must never fail on a fresh checkout)."""
        p = _calibration_path(path)
        try:
            with open(p) as f:
                rec = json.load(f)
            fit = rec["backends"][backend]
            return cls(alpha=float(fit["alpha"]), beta=float(fit["beta"]),
                       gamma=float(fit["gamma"]), source=str(p))
        except (OSError, KeyError, ValueError, TypeError):
            return cls.default()

    def save(self, path=None, backend: str = "sim",
             extra: Optional[dict] = None) -> Path:
        """Merge-persist this fit under ``backends[backend]``."""
        p = _calibration_path(path)
        rec = {}
        try:
            with open(p) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            pass
        rec.setdefault("backends", {})[backend] = {
            "alpha": self.alpha, "beta": self.beta, "gamma": self.gamma,
            **(extra or {}),
        }
        tmp = p.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
        return p


# ---------------------------------------------------------------------------
# structural features of a plan under a config
# ---------------------------------------------------------------------------

def _ring_is_inter(ring: Sequence[int], n_ranks: int,
                   bandwidth_groups: int) -> bool:
    """True when any hop of the ring (wrap included) crosses a bandwidth
    island (cfg.bandwidth_groups equal blocks of consecutive ranks)."""
    if bandwidth_groups <= 1 or n_ranks % bandwidth_groups != 0:
        return False
    isl = n_ranks // bandwidth_groups
    return any(ring[i] // isl != ring[(i + 1) % len(ring)] // isl
               for i in range(len(ring)))


def _lane_cap_for(rings: list, cfg) -> int:
    """Burst cap of the lane the given rings would run on (tables.py
    computes the authoritative per-lane value; this mirrors it for
    prediction)."""
    B = cfg.burst_slices
    inter = any(_ring_is_inter(r, cfg.n_ranks, cfg.bandwidth_groups)
                for r in rings)
    cap = cfg.inter_burst_cap if inter else cfg.intra_burst_cap
    return max(1, min(B, cap)) if cap > 0 else B


def _stage_features(kind: CollKind, ring_size: int, n_elems: int,
                    rings: list, cfg) -> tuple[float, float]:
    """(supersteps, wire bytes) of one ring stage under ``cfg``."""
    ns, rounds = derive_slicing(n_elems, ring_size, cfg.slice_elems,
                                cfg.conn_depth)
    P = program_len(CollKind(kind), ring_size)
    cap = _lane_cap_for(rings, cfg)
    supersteps = P * rounds * (-(-ns // cap))               # ceil
    bytes_ = (P * rounds * ns * cfg.slice_elems
              * _WIRE_ITEMSIZE[cfg.dtype])
    return float(supersteps), float(bytes_)


def plan_features(cfg, kind: CollKind, n_elems: int, group_size: int,
                  hierarchy: Optional[tuple], algo: str,
                  root: int = 0) -> dict:
    """Structural cost features of ``algo`` for this payload/topology:
    ``{"supersteps", "bytes", "stages"}`` — the model's regressors.

    The members are taken as ranks ``0..group_size-1`` in ring order (the
    bandwidth-island assignment is positional, so predicted lane classes
    match the tables-layer ``lane_caps`` of any same-shaped registration).
    """
    from .algos import build_plan, default_hierarchy

    if cfg is None:
        from .config import OcclConfig

        cfg = OcclConfig(n_ranks=max(group_size, 1))
    members = tuple(range(group_size))
    if algo == "ring":
        rings = [members]
        s, b = _stage_features(kind, group_size, n_elems, rings, cfg)
        return {"supersteps": s, "bytes": b, "stages": 1.0, "algo": algo}
    hier = (tuple(hierarchy) if hierarchy is not None
            else default_hierarchy(group_size))
    plan = build_plan(algo, kind, members, hier, n_elems, root)
    supersteps = bytes_ = 0.0
    for stage in plan.stages:
        rings = [stage.members[i:i + stage.ring_size]
                 for i in range(0, len(stage.members), stage.ring_size)]
        s, b = _stage_features(stage.kind, stage.ring_size, stage.n_elems,
                               rings, cfg)
        supersteps += s
        bytes_ += b
    return {"supersteps": supersteps, "bytes": bytes_,
            "stages": float(len(plan.stages)), "algo": algo}


# ---------------------------------------------------------------------------
# fitting (chip_smoke.py's algos sweep drives this)
# ---------------------------------------------------------------------------

def _rank_violations(pred: np.ndarray, y: np.ndarray,
                     groups: Sequence[Sequence[int]]) -> int:
    """Ordered pairs within a group whose measured order the prediction
    gets wrong (sample i measurably faster than j, predicted >= j)."""
    viol = 0
    for idx in groups:
        for a in idx:
            for b in idx:
                if y[a] < y[b] and pred[a] >= pred[b]:
                    viol += 1
    return viol


def fit(samples: Sequence[dict]) -> CostModel:
    """Rank-aware non-negative least squares of measured wall-clock on
    the three features, weighted by 1/wall (each sample contributes its
    RELATIVE error, so microsecond-scale and second-scale samples count
    equally).

    ``samples``: dicts with ``supersteps``, ``bytes``, ``stages`` and the
    measured ``wall`` (seconds); an optional ``tag``
    (``"<kind>/<size>/<algo>"``) groups samples that competed on the SAME
    payload/topology.  Non-negativity matters: a negative fitted
    coefficient (possible with few, collinear samples) would let auto
    rank a plan BETTER for moving more bytes.  With only three regressors
    the exact active-set search over the 8 sign patterns is cheap and
    deterministic.

    Candidate support sets are ranked by (pairwise ranking violations
    within each tag group, THEN weighted squared error).  The model's
    only job is selection — picking the measured winner per config —
    and with few collinear samples the globally error-minimal plane can
    invert a close small-payload ordering that a slightly-worse-error
    support set preserves.  Minimizing rank violations first keeps the
    calibrated ``auto`` on the measured winner; the error term breaks
    ties among equally-consistent fits.
    """
    pts = [s for s in samples if s.get("wall", 0) > 0]
    if len(pts) < 3:
        raise ValueError(
            f"need >= 3 measured samples to fit (got {len(pts)})")
    X = np.array([[s["supersteps"], s["bytes"], s["stages"]]
                  for s in pts], float)
    y = np.array([s["wall"] for s in pts], float)
    # Samples sharing a "<kind>/<size>" tag prefix competed on one
    # config; untagged samples form no pairs (ranking-neutral).
    by_cfg: dict = {}
    for i, s in enumerate(pts):
        tag = s.get("tag")
        if tag:
            by_cfg.setdefault(tag.rsplit("/", 1)[0], []).append(i)
    groups = [idx for idx in by_cfg.values() if len(idx) > 1]
    w = 1.0 / y
    Xw, yw = X * w[:, None], y * w
    best, best_key = None, (np.inf, np.inf)
    for mask in range(1, 8):                     # non-empty support sets
        cols = [j for j in range(3) if mask & (1 << j)]
        coef, *_ = np.linalg.lstsq(Xw[:, cols], yw, rcond=None)
        if (coef < 0).any():
            continue
        full = np.zeros(3)
        full[cols] = coef
        err = float(((Xw @ full - yw) ** 2).sum())
        key = (_rank_violations(X @ full, y, groups), err)
        if key < best_key:
            best, best_key = full, key
    assert best is not None, "all-zero fit is always feasible"
    return CostModel(alpha=float(best[0]), beta=float(best[1]),
                     gamma=float(best[2]), source=f"fit[{len(pts)}]")
