"""The record's serving cell (``BENCH_collectives.json`` -> ``serving``,
``benchmarks/bench_serving.py``'s ``REPLAY``) on the port, through the
replay function ``chip_smoke.py`` runs on the card, here on the CPU:
decode p99 52 supersteps, 44 preempts and 780 supersteps with preemption,
386.65 / 0 / 2292 without, the background tenant drained in both.  A
shorter replay (2 requests) runs through the reference's ``ServingQos``
too, and its decode p50 and p99, prefill p99, supersteps, preempts and
drain must equal the port's."""
import importlib.util
import json
import pathlib
import sys

import pytest

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_collectives.json").read_text())[
    "serving"]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench():
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import bench_serving
    finally:
        sys.path.pop(0)
    return bench_serving


@pytest.mark.parametrize("preemption", [True, False])
def test_serving_record_counts(preemption):
    cs = _smoke()
    assert cs.SERVING_REPLAY == _bench().REPLAY
    want = RECORD["preempt_on" if preemption else "preempt_off"]
    got = cs.serving_replay(preemption, "cpu")
    assert cs.SERVING_COUNTS[preemption] == {
        "p99": want["decode"]["p99"], "preempts": want["preempts"],
        "supersteps": want["supersteps"]}
    assert {k: got[k] for k in cs.SERVING_COUNTS[preemption]} \
        == cs.SERVING_COUNTS[preemption]
    assert got["p50"] == want["decode"]["p50"]
    assert len(got["decode_latencies"]) == want["decode"]["samples"]
    assert got["background_drained"] and want["background_drained"]
    assert got["drain_supersteps"] == want["drain_supersteps"]


@pytest.mark.parametrize("preemption", [True, False])
def test_short_replay_equals_reference(preemption):
    cs, bs = _smoke(), _bench()
    spec = dict(cs.SERVING_REPLAY, n_requests=2)
    got = cs.serving_replay(preemption, "cpu", spec)
    want = bs.replay(preemption, spec)
    assert got["p99"] == want["decode"]["p99"]
    assert got["p50"] == want["decode"]["p50"]
    assert got["prefill_p99"] == want["prefill"]["p99"]
    assert got["supersteps"] == want["supersteps"]
    assert got["preempts"] == want["preempts"]
    assert got["drain_supersteps"] == want["drain_supersteps"]
    assert got["background_drained"] and want["background_drained"]
