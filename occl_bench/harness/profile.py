"""A profiled slice of the daemon's tick loop, and what the trace holds.

``torch.profiler`` over a whole step would record millions of kernel
events, so a traced run profiles one bounded slice: it counts the
supersteps the tick loop is asked for (``SimTicker.run``, which every
launch, host-driven tick and in-step tick goes through) in the armed step,
starts the profiler after ``skip`` of them and stops it after ``span``
more, each end after a device sync.  The slice pattern follows
``chip_smoke.py:3339-3392`` (``profile_launch``), with two changes: busy
time is the union of the device intervals (a sum of kernel times counts
concurrent streams twice), and the slice sits inside a step.
"""
from __future__ import annotations

import bisect
import re
import time

import torch

BURST_KERNEL = re.compile(r"\bfused_burst_kernel<")   # chip_smoke.py:3335
SKIP_SUPERSTEPS = 512
SPAN_SUPERSTEPS = 256
TOP = 10
LABEL_SCAN = 400      # host events searched back for one covering a gap


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class SliceProfiler:
    def __init__(self, device, skip: int = SKIP_SUPERSTEPS,
                 span: int = SPAN_SUPERSTEPS, open_spans=list):
        from repro_torch.core.daemon import SimTicker

        self.device, self.skip, self.span = device, skip, span
        self.open_spans, self.outer = open_spans, "-"
        self.armed = self.done = False
        self.seen = 0
        self.prof = None
        self.steps: list = []
        self.wall_s = 0.0
        self._cls, self._orig = SimTicker, SimTicker.run
        me = self

        def run(ticker, st, inbox, k):
            if me.armed and me.prof is None and me.seen >= me.skip:
                me._start()
            out = me._orig(ticker, st, inbox, k)
            if me.prof is not None and not me.done:
                me.steps.append(out[2])
            if me.armed:
                me.seen += int(k)
                if me.prof is not None and me.seen >= me.skip + me.span:
                    me._stop()
            return out

        SimTicker.run = run

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.device)
        # a span opened before the profiler leaves no range in its trace
        self.outer = "/".join(self.open_spans()) or "-"
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def _stop(self) -> None:
        _sync(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.armed, self.done = False, True

    def arm(self) -> None:
        if not self.done and not self.armed:
            self.armed, self.seen = True, 0

    def close(self) -> None:
        """Stop a slice the step ended inside of."""
        if self.prof is not None and not self.done:
            self._stop()
        self.armed = False

    def restore(self) -> None:
        self._cls.run = self._orig

    def result(self):
        """The slice's device reading, or None where it holds no device
        event."""
        if self.prof is None:
            return None
        return analyse(self.prof.events(), self.wall_s,
                       int(sum(int(s) for s in self.steps)), self.outer)


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top(totals: dict) -> list:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


def analyse(events, wall_s: float, supersteps: int, outer: str = "-"):
    """Busy seconds (union of device intervals), kernel time by name, the
    ``fused_burst`` launches, and the idle gaps between device intervals,
    each labelled by the benchmark span and the innermost host event open
    at its middle (``outer``: the span open when the slice began).  Times
    in the trace are microseconds."""
    dev, host, bench = [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("bench:"):
            # the span's range; on the device timeline an annotation only
            if not _is_device(e):
                bench.append((a, b, e.name[6:]))
        elif e.name.startswith("occl:") and _is_device(e):
            continue        # the program tracer's range, not device work
        elif _is_device(e):
            dev.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
    if not dev:
        return None
    merged = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in merged)
    by_name, burst = {}, []
    for a, b, name in dev:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (b - a) / 1e6
        if BURST_KERNEL.search(name):
            burst.append(b - a)
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict = {}
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        label = _label((g0 + g1) / 2, host, starts, bench, outer)
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    return {"busy_s": busy_us / 1e6, "wall_s": wall_s,
            "supersteps": supersteps, "kernels": len(dev),
            "device_ops": _top(by_name), "idle_gaps": _top(gaps),
            "burst_launches": len(burst),
            "burst_mean_s": (sum(burst) / len(burst) / 1e6) if burst
            else None}


def _label(t: float, host: list, starts: list, bench: list,
           outer: str) -> str:
    span = next((n for a, b, n in bench if a <= t <= b), outer)
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - LABEL_SCAN), -1):
        if host[j][1] >= t:
            return f"{span} > {host[j][2][:80]}"
    return f"{span} > (no host event)"
