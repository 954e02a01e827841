"""Serving QoS on the port (``repro_torch.serving.qos``): the reference's
``tests/test_serving_qos.py`` on real port fabrics on the CPU, and the
port's ``ServingQos`` against the reference's on the same traffic.

Parity is exact: supersteps, preempts, the per-class latency samples (in
supersteps on the replay clock) and each record's completion stamp equal
the reference's, since the fabric's counts and the callbacks' order
(``HostQueues.reconcile``) are the reference's.
"""
import numpy as np
import pytest
import torch

import repro.serving.qos as JQ
from repro_torch.core.config import OcclConfig, OrderPolicy
from repro_torch.core.primitives import CollKind
from repro_torch.core.runtime import OcclRuntime
from repro_torch.fabric.ft import ReliabilityController
from repro_torch.serving.qos import (AGING_CAP, CLASS_STRIDE, ServingQos,
                                     TrafficClass, class_prio)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(n_ranks=2, decode_elems=64, prefill_elems=128,
             background_elems=1024, background_buckets=1)


def _qos(mod=None, **kw):
    kw = {**SMALL, **kw}
    if mod is JQ:
        return JQ.ServingQos(**kw)
    return ServingQos(device="cpu", **kw)


def test_class_prio_ladder():
    assert class_prio(TrafficClass.BACKGROUND) == 0
    assert class_prio(TrafficClass.PREFILL) == CLASS_STRIDE
    assert class_prio(TrafficClass.DECODE) == 2 * CLASS_STRIDE
    assert class_prio(TrafficClass.PREFILL, CLASS_STRIDE - 1) \
        < class_prio(TrafficClass.DECODE)
    with pytest.raises(ValueError):
        class_prio(TrafficClass.DECODE, CLASS_STRIDE)
    assert AGING_CAP == 2 * CLASS_STRIDE - 1
    assert class_prio(TrafficClass.BACKGROUND) + AGING_CAP \
        < class_prio(TrafficClass.DECODE)
    for cls in TrafficClass:          # the reference's ladder, class by class
        assert class_prio(cls, 3) == JQ.class_prio(JQ.TrafficClass(cls), 3)
    assert (CLASS_STRIDE, AGING_CAP) == (JQ.CLASS_STRIDE, JQ.AGING_CAP)


def test_high_priority_cqe_first_and_preempts():
    """The decode submit lands while the background burst holds the lane,
    yet completes first with the preempt counter advancing."""
    qos = _qos(preemption=True)
    bg = qos.submit_background()
    qos.advance(2)
    dec = qos.submit_decode()
    qos.wait(dec)
    assert dec["done_at"] is not None
    assert bg["done_at"] is None
    qos.drain()
    assert bg["done_at"] > dec["done_at"]
    assert qos.summary()["preempts"] > 0


def decode_latency(mod, preemption):
    qos = _qos(mod, preemption=preemption)
    qos.submit_background()
    qos.advance(2)
    lat = qos.wait(qos.submit_decode())
    qos.drain()
    s = qos.summary()
    return lat, s["supersteps"], s["preempts"]


def test_fifo_baseline_decode_waits_out_background():
    """Preemption off: FIFO holds and decode pays the whole background
    transfer.  Both regimes equal the reference's latencies and counts."""
    on = decode_latency(None, True)
    off = decode_latency(None, False)
    assert on[0] < off[0]
    assert on[2] > 0 and off[2] == 0
    assert on == decode_latency(JQ, True)
    assert off == decode_latency(JQ, False)


def test_background_admission_cap():
    qos = _qos(preemption=True, background_buckets=3,
               max_background_inflight=2)
    assert qos.pump_background() == 2
    assert qos.submit_background() is None
    qos.drain()
    assert qos.admit_background()
    assert qos.pump_background() == 2
    qos.drain()
    bg = qos.tenants[TrafficClass.BACKGROUND]
    assert bg.completed == bg.submitted == 4


def test_priority_aging_bounds_starvation():
    """A continuous high-priority stream starves a low-priority burst
    under pure PRIORITY order; with aging the burst wins the lane."""
    def run(quantum):
        cfg = OcclConfig(
            n_ranks=2, max_colls=8, max_comms=1, slice_elems=32,
            conn_depth=2, order_policy=OrderPolicy.PRIORITY,
            priority_preempts=True, prio_aging_quantum=quantum,
            prio_aging_cap=511, quit_threshold=64)
        rt = OcclRuntime(cfg, device="cpu")
        comm = rt.communicator([0, 1])
        lo = rt.register(CollKind.ALL_REDUCE, comm, n_elems=256)
        hi = rt.register(CollKind.ALL_REDUCE, comm, n_elems=32)
        done = {"lo": None, "hi": 0}
        hi_cqes = [0]

        def lo_cb(rank, cid):
            done["lo"] = True

        def hi_cb(rank, cid):
            hi_cqes[0] += 1
            if hi_cqes[0] == cfg.n_ranks:
                hi_cqes[0] = 0
                done["hi"] += 1

        hi_subs = [0]
        rt.submit_all(lo, prio=0, callback=lo_cb)
        api = rt.device_api()
        for _ in range(120):
            if done["hi"] == hi_subs[0]:
                rt.submit_all(hi, prio=8, callback=hi_cb)
                hi_subs[0] += 1
            rt._flush_staged()
            st = rt.queues.pack_sq(rt._state)
            st, _ = api.tick(st, 1, barrier=True)
            rt._state = st
            rt.queues.reconcile(st)
        return done

    aged = run(quantum=2)
    starved = run(quantum=0)
    assert aged["lo"] is True
    assert starved["lo"] is None
    assert aged["hi"] > 0 and starved["hi"] > 0


def test_diagnose_names_wedged_tenant():
    """Background submitted on rank 0 only: both the QoS diagnosis and the
    serving-bound ReliabilityController name the BACKGROUND tenant with
    the lagging rank as holder."""
    qos = _qos(preemption=True)
    bgh = qos.background[0]
    bgh.submit(0, data=np.ones(1024, np.float32))
    qos.advance(4)
    diag = qos.diagnose()
    assert len(diag) == 1
    assert diag[0]["tenant"] == "BACKGROUND"
    assert diag[0]["holding_ranks"] == [1]
    assert "never submitted" in diag[0]["reason"]
    ctrl = ReliabilityController.for_serving(qos)
    named = ctrl.diagnose_tenants()
    assert named and named[0]["tenant"] == "BACKGROUND"
    assert named[0]["coll_id"] == int(bgh)


def test_straggler_detector_observes_serving_tenant():
    qos = _qos(preemption=True)
    ctrl = ReliabilityController.for_serving(qos)
    for _ in range(3):
        qos.wait(qos.submit_decode())
    ctrl.observe_step()
    assert ctrl.detector.coll_seen.any()
    assert not ctrl.detector.suspect.any()
    assert ctrl.detector.healthy_ranks() == list(range(2))


def determinism_run(mod):
    qos = _qos(mod, preemption=True, prio_aging_quantum=8)
    lats = []
    for _ in range(3):
        qos.pump_background()
        lats.append(qos.wait(qos.submit_decode()))
    qos.drain()
    return lats, qos.summary()["preempts"]


def test_replay_determinism():
    """Identical traffic on identical configs gives identical superstep
    latencies — and the reference's."""
    got = determinism_run(None)
    assert got == determinism_run(None)
    assert got == determinism_run(JQ)


def test_summary_counts_reconcile():
    qos = _qos(preemption=True)
    recs = [qos.submit_decode(), qos.submit_prefill(),
            qos.submit_background()]
    qos.drain()
    assert all(r["done_at"] is not None for r in recs)
    s = qos.summary()
    for cls in TrafficClass:
        t = qos.tenants[cls]
        assert t.completed == t.submitted
        assert s[cls.name.lower()]["completed"] == t.completed
        assert len(t.latencies) == t.completed


def test_entry_point_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: ServingQos() runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingQos(**SMALL)
