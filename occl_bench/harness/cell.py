"""One run of one cell: set-up, the window, the traced readings, the
check against the reference, and the result line's contents."""
from __future__ import annotations

import sys
import time

import torch

from ..roofline import flops, peaks
from . import compare, manifest
from .profile import SliceProfiler
from .spans import program_spans, sync
from .window import Ctx, Window, cell_config

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Tracer:
    """Spans around the program's calls through the window, and one
    profiled slice of the step after it.  The spans stay open through that
    step (they label the trace's idle gaps) but only the window's count.
    With ``program`` the program's own tracer (``core/trace.py``) records
    through the window too, and ``snapshot`` holds what it recorded."""

    def __init__(self, device, program: bool = False):
        self.device, self.program = device, program
        self.spans = program_spans(device)
        self.slice = SliceProfiler(device, open_spans=self.spans.open_names)
        self.kept = None
        self.snapshot = None

    def start(self) -> None:
        self.spans.on = True
        if self.program:
            from repro_torch.core import trace

            trace.reset()
            trace.enable()

    def stop(self) -> None:
        self.kept = len(self.spans.records)
        if self.program:
            from repro_torch.core import trace

            sync(self.device)
            self.snapshot = trace.snapshot()
            trace.disable()

    def arm(self) -> None:
        self.slice.arm()

    def restore(self) -> None:
        self.spans.restore()
        self.slice.restore()


def loaded_forbidden() -> list:
    """Modules loaded whose top-level name is one the harness and the
    program must never load (compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def trace_record(cfg: dict, window, tracer: Tracer) -> dict:
    """What a per-layer reader (``metrics/<name>.py``) gets."""
    sp, n = tracer.spans, tracer.kept
    return {
        "config": cfg, "steps": window.steps, "window_s": window.window_s,
        "supersteps": window.delta("supersteps"),
        "overlap_supersteps": window.delta("overlap_supersteps"),
        "counters": window.deltas(),
        "program": tracer.snapshot,
        "spans": {"drive": sp.total("drive", True, n),
                  "flush": sp.total("flush", upto=n),
                  "read": sp.total("read", upto=n),
                  "tick": sp.total("tick", True, n),
                  "runtime": sp.top_total(n)},
        "profile": tracer.slice.result(),
        "step_flops": flops.step_flops(cfg),
        "peak_flops_per_s": peaks.MATMUL_FLOPS_PER_S[
            cfg["precision"]["peak"]],
    }


def context(cfg: dict, wl: dict, seed: int, device, window) -> Ctx:
    """A driver's context: the cell's configuration and traffic, with the
    family and the reference the configuration names."""
    return Ctx(cfg, wl, seed, device, window,
               manifest.family(cfg["family"]),
               manifest.reference(cfg["reference"]))


def run(cfg: dict, wl: dict, seed: int, seconds: float, device,
        t_start: float, metrics=(), trace: bool = False, log=None) -> dict:
    """Run the cell; returns the result's fields (without the import
    check, which the caller makes last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cfg = cell_config(cfg, wl)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    readers = {m["name"]: manifest.reader(m["name"]) for m in metrics}
    tracer = Tracer(device, any(getattr(r, "PROGRAM_TRACE", False)
                                for r in readers.values())) \
        if trace else None
    window = Window(seconds, device, tracer)
    try:
        out = manifest.driver(wl["driver"]).run(context(cfg, wl, seed,
                                                        device, window))
    finally:
        if tracer is not None:
            tracer.restore()
    setup_s = window.t0 - t_start
    log(f"[bench] set-up {setup_s:.3f} s; window {window.window_s:.3f} s, "
        f"{window.steps} steps of " + ", ".join(f"{t:.4f}" for t in
                                               window.times)
        + f" s; supersteps {window.delta('supersteps')}, preempts "
        f"{window.delta('preempts')}")
    res = {"attempted": window.steps, "failed": 0, "metrics": {},
           "setup_s": setup_s, "step_s": window.window_s / window.steps}
    res["memory_peak_bytes"] = torch.cuda.max_memory_allocated() \
        if cuda else 0
    if trace:
        rec = trace_record(cfg, window, tracer)
        prof = rec["profile"]
        if prof is not None:
            res["busy_s"], res["window_s"] = prof["busy_s"], prof["wall_s"]
            res["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
            log(f"[bench] profiled slice: {prof['supersteps']} supersteps,"
                f" {prof['kernels']} device events, busy "
                f"{prof['busy_s']:.6f} s of {prof['wall_s']:.6f} s")
        for m in metrics:
            value = readers[m["name"]].read(rec)
            if value is not None:
                res["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
    out.release()
    t0 = time.perf_counter()
    readings = out.check()
    res["check_s"] = time.perf_counter() - t0
    res["correct"], res["checks"] = compare.judge(readings, wl["limits"])
    res["readings"] = readings
    return res
