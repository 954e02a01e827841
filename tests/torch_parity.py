"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

A scenario is a function of one package (``repro.core`` or
``repro_torch.core``) that builds a runtime, drives it and returns
``(runtime, {key: output array})``.  :func:`run_both` runs it on both
packages — the port on the CPU — and holds the outputs (bitwise, NaN
payloads included), the scheduler's counters and the flight recorder's
per-kind counts of the two runs equal.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test with one PyTorch CPU thread, restored afterwards.
    The port's supersteps are many small tensor ops; with several test
    workers on one machine, each spinning up every core's worth of
    intra-op threads, they oversubscribe the CPU several times over.  One
    thread changes no result: every float op of the port is elementwise
    and every reduction is over integers.  Test modules import this
    fixture to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("supersteps", "preempts", "stall_slices", "stage_completions",
            "completed", "slices_moved", "rtc_events", "cq_count")


def runtime(core, cost_model=None, **cfg_kw):
    """A runtime of either package; the port's on the CPU."""
    cfg = core.OcclConfig(**cfg_kw)
    if core is T:
        return core.OcclRuntime(cfg, device="cpu", cost_model=cost_model)
    return core.OcclRuntime(cfg, cost_model=cost_model)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def assert_same_outputs(jo: dict, to: dict) -> None:
    assert jo.keys() == to.keys()
    for k in jo:
        want = np.asarray(jo[k]).astype(np.float32)
        got = np.asarray(to[k]).astype(np.float32)
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=str(k))


def assert_same_counters(jrt, trt) -> None:
    js, ts = jrt.stats(), trt.stats()
    for k in COUNTERS:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(ts["flight_recorder"]["kind_counts"],
                                  js["flight_recorder"]["kind_counts"])
    assert ts["chains"] == js["chains"]
    assert ts["algos"] == js["algos"]
    assert trt.launches == jrt.launches


def run_both(scenario, *args, **kw):
    """Run ``scenario(core, *args, **kw)`` on both packages and hold the two
    runs equal; returns the port's ``(runtime, outputs)``."""
    jrt, jo = scenario(J, *args, **kw)
    trt, to = scenario(T, *args, **kw)
    assert_same_outputs(jo, to)
    assert_same_counters(jrt, trt)
    return trt, to


def assert_tables_equal(jt, tt) -> None:
    """Two ``StaticTables`` field by field (lists of arrays included)."""
    import dataclasses

    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            assert b.dtype == a.dtype, f.name
        elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            assert a == b, f.name
