"""In-program spans of the daemon's layers, with the device time of the
chunks they issue.  Off by default.

``enable()`` / ``disable()`` switch it for the process, ``reset()`` drops
what it holds, and ``snapshot()`` returns it as a dict.  ``span(name,
device=False, units=0)`` is a context manager:

* **off**: one check of a module flag, then a shared no-op context: no
  CUDA event, no profiler range, no record and no device sync.
* **on**: each span records its name, its parent (the innermost span open
  in the same thread when it opened), its start and end on
  ``time.perf_counter_ns()`` and its ``units`` into a bounded ring, and
  adds to per-name totals: count, host seconds, self seconds (its duration
  less its children's) and units.
* ``device=True`` also records a pair of timing CUDA events on the current
  stream (taken from a pool, so a steady run allocates none).  Completed
  pairs fold into per-name device seconds with ``Event.query()``, never
  blocking; ``snapshot()`` folds the rest, so the caller calls it after a
  sync of its own.  A device span inside an open :data:`LOOP` span is also
  a gap boundary: the device interval from one such span's end event to
  the next one's begin event, inside one loop, is that loop's gap (what
  the host's work between two chunks costs the device).
* While a ``torch.profiler`` session records, each span also opens a range
  named ``"occl:" + name`` (a span's ``t0_ns`` is read right before its
  range opens); at ``enable()`` and at the first span after a profiler
  started the tracer stamps an ``occl:clock`` range beside its own
  ``perf_counter_ns`` readings, which places every span record on the
  profiler's timeline: the marker's range closes right after its
  ``t1_ns``, so its end and ``t1_ns`` are the same instant on the two
  clocks (its start may lag ``t0_ns`` by the first range's set-up).
"""
from __future__ import annotations

import collections
import threading
import time

import torch

LOOP = "occl.loop"
RING = 65536                 # span records kept, newest last
POOL = 32                    # timing events made at enable() on a card


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _totals() -> dict:
    return {"count": 0, "host_ns": 0, "self_ns": 0, "units": 0,
            "device_s": 0.0, "device_units": 0, "gap_s": 0.0, "gaps": 0,
            "chunk_device_s": 0.0}


class _Tracer:
    """What one tracing session holds (``reset()`` starts a new one; the
    event pool carries over)."""

    def __init__(self, pool=None):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.records: collections.deque = collections.deque(maxlen=RING)
        self.totals: dict = collections.defaultdict(_totals)
        self.seq = 0
        self.done = 0
        self.pending: collections.deque = collections.deque()
        self.pool: list = pool if pool is not None else []
        self.refs: dict = {}             # id(event) -> [event, references]
        self.clock: list = []            # (t0_ns, t1_ns) around occl:clock
        self.profiling = False

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    # -- timing events ---------------------------------------------------
    def event(self):
        ev = self.pool.pop() if self.pool else torch.cuda.Event(
            enable_timing=True)
        ev.record()
        self.refs[id(ev)] = [ev, 1]
        return ev

    def retain(self, ev) -> None:
        self.refs[id(ev)][1] += 1

    def release(self, ev) -> None:
        ref = self.refs[id(ev)]
        ref[1] -= 1
        if not ref[1]:
            del self.refs[id(ev)]
            self.pool.append(ev)

    def fold(self, wait: bool = False) -> None:
        """Fold completed event pairs into their totals, oldest first;
        ``wait`` folds every pair (after the caller's sync)."""
        p = self.pending
        while p:
            a, b, keys, units = p[0]
            if wait:
                b.synchronize()
                a.synchronize()
            elif not (b.query() and a.query()):
                return
            s = a.elapsed_time(b) / 1e3
            for name, field in keys:
                tot = self.totals[name]
                tot[field] += s
                if field == "gap_s":
                    tot["gaps"] += 1
                elif field == "device_s":
                    tot["device_units"] += units
            p.popleft()
            self.release(a)
            self.release(b)

    def stamp(self) -> None:
        """The ``occl:clock`` marker: ``t0_ns`` before its profiler range
        opens, ``t1_ns`` right before it closes."""
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function("occl:clock"):
            t1 = time.perf_counter_ns()
        self.clock.append((t0, t1))


class _Span:
    __slots__ = ("tr", "name", "device", "units", "parent", "loop", "seq",
                 "t0", "child_ns", "ev0", "rf", "last_end")

    def __init__(self, tr: _Tracer, name: str, device: bool, units: int):
        self.tr, self.name, self.device, self.units = tr, name, device, units

    def __enter__(self):
        tr = self.tr
        stack = tr.stack()
        parent = self.parent = stack[-1] if stack else None
        self.loop = self if self.name == LOOP else (
            parent.loop if parent is not None else None)
        self.child_ns, self.ev0, self.rf, self.last_end = 0, None, None, None
        with tr.lock:
            tr.seq += 1
            self.seq = tr.seq
            profiling = torch.autograd._profiler_enabled()
            if profiling and not tr.profiling:
                tr.stamp()
            tr.profiling = profiling
            # the start sits right before the profiler range opens
            self.t0 = time.perf_counter_ns()
            if profiling:
                self.rf = torch.profiler.record_function("occl:" + self.name)
                self.rf.__enter__()
            if self.device and not torch.cuda.is_current_stream_capturing():
                self.ev0 = tr.event()
                loop = self.loop
                if loop is not None and loop.last_end is not None:
                    # the loop's reference on the last end passes to the gap
                    tr.retain(self.ev0)
                    tr.pending.append((loop.last_end, self.ev0,
                                       ((LOOP, "gap_s"),), 0))
                    loop.last_end = None
        stack.append(self)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        tr.stack().pop()
        with tr.lock:
            if self.ev0 is not None:
                ev1 = tr.event()
                keys = (self.name, "device_s"),
                loop = self.loop
                if loop is not None and loop is not self:
                    keys += (LOOP, "chunk_device_s"),
                    tr.retain(ev1)
                    loop.last_end = ev1
                tr.pending.append((self.ev0, ev1, keys, self.units))
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            if self.loop is self and self.last_end is not None:
                tr.release(self.last_end)
                self.last_end = None
            t1 = time.perf_counter_ns()
            dur = t1 - self.t0
            if self.parent is not None:
                self.parent.child_ns += dur
            tot = tr.totals[self.name]
            tot["count"] += 1
            tot["host_ns"] += dur
            tot["self_ns"] += dur - self.child_ns
            tot["units"] += self.units
            tr.done += 1
            tr.records.append((self.seq, self.name,
                               self.parent.seq if self.parent else 0,
                               self.t0, t1, self.units))
            tr.fold()
        return False


_on = False
_tracer = _Tracer()


def span(name: str, device: bool = False, units: int = 0):
    """A span of ``name`` (see the module docstring); ``units`` is the
    work it stands for (supersteps for a chunk)."""
    if not _on:
        return _NULL
    return _Span(_tracer, name, device, units)


def enable() -> None:
    global _on
    _on = True
    tr = _tracer
    if torch.cuda.is_available():
        while len(tr.pool) < POOL:
            tr.pool.append(torch.cuda.Event(enable_timing=True))
    tr.stamp()


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop every record, total and pending event pair."""
    global _tracer
    _tracer = _Tracer(_tracer.pool)


def snapshot() -> dict:
    """Everything recorded since the last ``reset()``, as plain data:
    ``spans`` (per name: ``count``, ``host_s``, ``self_s``, ``units``,
    ``device_s`` over ``device_units``; a loop's ``gap_s`` over ``gaps``
    and the ``chunk_device_s`` inside it), ``records`` (the ring: ``seq``,
    ``name``, ``parent`` seq (0: none), ``t0_ns``, ``t1_ns``, ``units``),
    ``dropped`` (records that fell off the ring) and ``clock`` (each
    ``occl:clock`` marker's ``t0_ns`` / ``t1_ns``).  Folds every pending
    device pair: call it after a device sync."""
    tr = _tracer
    with tr.lock:
        tr.fold(wait=True)
        spans = {}
        for name, t in tr.totals.items():
            d = {k: v for k, v in t.items() if not k.endswith("_ns")}
            d["host_s"] = t["host_ns"] / 1e9
            d["self_s"] = t["self_ns"] / 1e9
            spans[name] = d
        records = [dict(zip(("seq", "name", "parent", "t0_ns", "t1_ns",
                             "units"), r)) for r in tr.records]
        return {"spans": spans, "records": records,
                "dropped": tr.done - len(records),
                "clock": [{"t0_ns": a, "t1_ns": b} for a, b in tr.clock]}
