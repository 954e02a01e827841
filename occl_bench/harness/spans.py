"""Host-clock spans around the program's calls, for a traced run.

The pattern is ``chip_smoke.py:1762-1776`` (``split_calls``): each wrapped
call waits for the device before it starts and after it ends, so its span
holds the device work it issued.  Here the wrappers shadow methods on the
class (the drivers' runtimes are built inside the program's own calls), are
recorded per thread with their nesting depth, and open a profiler range
named ``bench:<span>`` so the device trace can say what the host was in.
A call made inside an open span of the same name (a tick inside a bounded
tick loop) is not timed again: its syncs would cost more than it does.
"""
from __future__ import annotations

import threading
import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    def __init__(self, device):
        self.device = device
        self.on = False
        self.records: list = []          # (name, depth, seconds)
        self._local = threading.local()
        self._undo: list = []

    def wrap(self, cls, method: str, name: str) -> None:
        fn = getattr(cls, method)
        spans = self

        def timed(*a, **kw):
            open_ = getattr(spans._local, "open", None)
            if open_ is None:
                open_ = spans._local.open = []
            if not spans.on or name in open_:
                return fn(*a, **kw)
            depth = len(open_)
            open_.append(name)
            try:
                sync(spans.device)
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench:" + name):
                    out = fn(*a, **kw)
                sync(spans.device)
                spans.records.append((name, depth,
                                      time.perf_counter() - t0))
                return out
            finally:
                open_.pop()

        setattr(cls, method, timed)
        self._undo.append((cls, method, fn))

    def open_names(self) -> list:
        """The spans open in the calling thread, outermost first."""
        return list(getattr(self._local, "open", None) or [])

    def restore(self) -> None:
        for cls, method, fn in reversed(self._undo):
            setattr(cls, method, fn)
        self._undo.clear()

    def total(self, name: str, top: bool = False, upto=None) -> float:
        return sum(s for n, d, s in self.records[:upto]
                   if n == name and (d == 0 or not top))

    def top_total(self, upto=None) -> float:
        """Seconds inside any outermost span."""
        return sum(s for _, d, s in self.records[:upto] if d == 0)


def program_spans(device) -> Spans:
    """Spans around the runtime's drive, staging flush and bulk read, and
    the in-step API's ticks and bounded tick loops."""
    from repro_torch.core.device_api import DeviceApi
    from repro_torch.core.runtime import OcclRuntime

    sp = Spans(device)
    sp.wrap(OcclRuntime, "drive", "drive")
    sp.wrap(OcclRuntime, "_flush_staged", "flush")
    sp.wrap(OcclRuntime, "read_outputs_bulk", "read")
    sp.wrap(DeviceApi, "tick", "tick")
    sp.wrap(DeviceApi, "tick_until", "tick")
    return sp
