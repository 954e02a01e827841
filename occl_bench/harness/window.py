"""The measured window and what a driver hands it and back.

A driver (``drivers/<driver>.py``, named by the cell's workload file)
builds the program's objects from the configuration, hands them the
weights and inputs its family draws from the seed
(``families/<family>.py``), runs the set-up the traffic names, opens the
window (``Window.start``), runs whole steps until the window closes, and
returns an :class:`Outcome` whose ``check()`` works the reference
(``reference/<reference>.py``, named by the configuration) out again once
the program is freed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from types import ModuleType

import numpy as np
import torch

from .spans import sync


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def counters(rt) -> dict:
    """The runtime's counters: ``supersteps`` and ``overlap_supersteps``
    (clocks: their maximum over ranks), ``preempts`` (summed), and every
    other number of ``stats()``, an integer array summed over its
    elements."""
    st, out = rt.stats(), {}
    for key, v in st.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "iu":
            out[key] = int(v.sum())
        elif isinstance(v, (int, float, np.integer, np.floating)) \
                and not isinstance(v, bool):
            out[key] = v
    for key in ("supersteps", "overlap_supersteps"):
        out[key] = int(st[key].max())
    return out


class Window:
    """The measured window: opened after set-up, closed by the first whole
    step that ends ``seconds`` or more after it opened and is at least its
    ``min_steps``-th.  A traced run's spans cover the window; its profiled
    slice lies in one more step after the window (``profiling``), so the
    profiler's cost stays out of every timed reading."""

    def __init__(self, seconds, device, tracer=None):
        self.seconds, self.device, self.tracer = seconds, device, tracer
        self.steps = 0
        self.times: list = []
        self.t0 = self.t1 = None
        self.rt = None
        self.min_steps = 1
        self.profiling = False

    def start(self, rt, min_steps: int = 1) -> None:
        """Open the window; it closes no earlier than ``min_steps`` steps
        on."""
        sync(self.device)
        self.rt, self.min_steps = rt, min_steps
        self.c0 = counters(rt)
        if self.tracer is not None:
            self.tracer.start()
        self.t0 = self.last = time.perf_counter()

    def _close(self) -> None:
        if self.tracer is not None:
            self.tracer.stop()
        self.c1 = counters(self.rt)
        self.rt = None

    def step_done(self) -> bool:
        """True once the run should stop stepping."""
        sync(self.device)
        if self.profiling:
            self.tracer.slice.close()
            return True
        t = time.perf_counter()
        self.times.append(t - self.last)
        self.last = t
        self.steps += 1
        if t - self.t0 < self.seconds or self.steps < self.min_steps:
            return False
        self.t1 = t
        self._close()
        if self.tracer is None:
            return True
        self.tracer.arm()
        self.profiling = True
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def delta(self, key: str):
        return self.c1[key] - self.c0[key]

    def deltas(self) -> dict:
        """Every counter's change over the window."""
        return {k: self.c1[k] - self.c0[k] for k in self.c1 if k in self.c0}


@dataclasses.dataclass
class Ctx:
    cfg: dict
    wl: dict
    seed: int
    device: object
    window: Window
    family: ModuleType       # families/<cfg["family"]>.py
    reference: ModuleType    # reference/<cfg["reference"]>.py


class Outcome:
    """What a driver hands back: ``release()`` (drop the program's
    objects) and ``check()`` (readings against the reference)."""

    def __init__(self, check, release):
        self._check, self._release = check, release

    def release(self) -> None:
        self._release()
        free()

    def check(self) -> dict:
        return self._check()


def cell_config(cfg: dict, wl: dict) -> dict:
    """The configuration as the cell runs it: the workload's
    ``deployment`` entries (its traffic: batch, tokens per rank) over the
    configuration's."""
    if not wl.get("deployment"):
        return cfg
    return dict(cfg, deployment=dict(cfg["deployment"], **wl["deployment"]))
