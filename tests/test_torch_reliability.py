"""Reliability on the port against the JAX reference: the hang diagnosis,
the enriched ``DeadlockTimeout``, ``evict`` (drain -> rebuild for R-1 ->
replay; flat, two-level R=8 -> 7, double, dissolving registrations),
handle survival, the straggler detector and ``ReliabilityController``
end to end — ``tests/test_reliability.py`` and the diagnosis cases of
``tests/test_recorder.py``, ported.  Where both packages run a scenario,
outputs, counters, the eviction report and the diagnosis are held equal.
"""
import warnings

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.fabric.ft import ReliabilityController as JController
from repro.fabric.straggler import StragglerDetector as JDetector
from repro_torch.core import errors as terrors
from repro_torch.fabric.ft import ReliabilityController, StepTimeout
from repro_torch.fabric.straggler import StragglerDetector
from torch_parity import (assert_same_counters, assert_same_outputs,
                          run_both, runtime)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _rt(core, R, **kw):
    kw.setdefault("max_colls", 12)
    kw.setdefault("max_comms", 4)
    kw.setdefault("slice_elems", 8)
    kw.setdefault("heap_elems", 1 << 13)
    return runtime(core, n_ranks=R, **kw)


def _payloads(R, n, seed=0):
    # Integer-valued floats: reductions are exact in f32 in any order.
    rng = np.random.RandomState(seed)
    return {r: rng.randint(0, 1 << 10, n).astype(np.float32)
            for r in range(R)}


def _diag(d):
    return [(s.coll_id, s.algo, tuple(s.members), list(s.waiting_ranks),
             list(s.holding_ranks), s.reason) for s in d.stalled]


# ---------------------------------------------------------------------------
# handles and errors
# ---------------------------------------------------------------------------

def handles(core):
    R = 4
    rt = _rt(core, R)
    comm = rt.communicator(range(R))
    h = rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=32)
    g = rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=16)
    assert isinstance(h, core.CollectiveHandle) and isinstance(h, int)
    assert h == 0 and h.reg_index == 0 and h.alive
    data, data2 = _payloads(R, 32), _payloads(R, 16, seed=1)
    fired = []
    h.submit_all(data=data, callback=lambda r, c: fired.append((r, c)))
    for r in range(R):                  # the bare-int shim
        rt.write_input(r, int(g), data2[r])
        rt.submit(r, int(g))
    rt.drive()
    assert sorted(fired) == [(r, 0) for r in range(R)]
    outs = {("h", r): h.read(r) for r in range(R)}
    outs.update({("g", r): v for (r, _), v in rt.read_outputs_bulk(
        [(r, int(g)) for r in range(R)]).items()})
    for r in range(R):
        np.testing.assert_array_equal(outs[("h", r)], sum(data.values()))
        np.testing.assert_array_equal(outs[("g", r)], sum(data2.values()))
    cs = h.stats()
    assert cs["coll_id"] == 0 and cs["stages"] == [0]
    assert int(cs["completed"].sum()) == R
    with pytest.raises(core.RegistrationClosed):
        rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=16)
    return rt, outs


def test_handles_and_int_shims_match_reference():
    run_both(handles)


def test_error_taxonomy_identity():
    from repro_torch.core.runtime import (ConnDepthWarning,
                                          DeadlockTimeout as D,
                                          RegistrationClosed)
    assert D is terrors.DeadlockTimeout is T.DeadlockTimeout
    assert RegistrationClosed is terrors.RegistrationClosed
    assert ConnDepthWarning is terrors.ConnDepthWarning
    assert StepTimeout is terrors.StepTimeout


def hang(core):
    """Rank 1 never submits: the timeout carries the recorder export and a
    diagnosis naming rank 1."""
    rt = _rt(core, 2, max_comms=1)
    h = rt.register(core.CollKind.ALL_REDUCE, rt.communicator(range(2)),
                    n_elems=16)
    h.submit(0, data=np.ones(16, np.float32))
    with pytest.raises(core.DeadlockTimeout) as ei:
        rt.drive(max_launches=3)
    e = ei.value
    assert e.flight_record is not None and e.flight_record["enabled"]
    assert e.diagnosis.holders == [1]
    assert "held by rank(s) 1" in str(e)
    return rt, {"msg": np.frombuffer(str(e).encode(), np.uint8)
                .astype(np.float32)}


def test_deadlock_timeout_carries_record_and_diagnosis():
    run_both(hang)


def withheld(core):
    """Conflicting static orders (a proven single-FIFO deadlock); rank 2
    withholds one collective entirely: the diagnosis names exactly it."""
    R, C = 4, 4
    rng = np.random.RandomState(0)
    orders = {r: list(rng.permutation(C)) for r in range(R)}
    assert core.run_static_order(
        orders, {c: list(range(R)) for c in range(C)}).deadlocked
    rt = _rt(core, R)
    comm = rt.communicator(range(R))
    hs = [rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=16)
          for _ in range(C)]
    for r in range(R):
        for c in orders[r]:
            if not (r == 2 and c == 2):
                hs[c].submit(r, data=np.full(16, float(r), np.float32))
    with pytest.raises(core.DeadlockTimeout) as ei:
        rt.drive(max_launches=4)
    diag = ei.value.diagnosis
    blocked = {s.coll_id: s for s in diag.stalled}[int(hs[2])]
    assert blocked.holding_ranks == [2]
    assert "never submitted" in blocked.reason and str(diag)
    return rt, {("diag", i): np.asarray(d[3] + d[4], np.float32)
                for i, d in enumerate(_diag(diag))}


def test_diagnose_names_withheld_rank():
    (jrt, jo), (trt, to) = withheld(J), withheld(T)
    assert_same_outputs(jo, to)
    assert_same_counters(jrt, trt)
    assert _diag(T.diagnose(trt)) == _diag(J.diagnose(jrt))


# ---------------------------------------------------------------------------
# evict
# ---------------------------------------------------------------------------

def evict_flat(core):
    """Kill rank 1 mid-flight at R=4: the shrunk runtime's outputs and
    supersteps equal a fresh 3-rank runtime's."""
    R, n = 4, 32
    data = _payloads(R, n)
    rt = _rt(core, R)
    h = rt.register(core.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    for r in range(R):
        h.submit(r, data=data[r])
    rt.drive()
    for r in (0, 2, 3):
        h.submit(r, data=data[r])
    report = rt.evict(1)
    assert report["n_ranks"] == 3 and report["replayed"] == 3
    assert h.alive and h.coll_id == 0
    fresh = _rt(core, 3)
    hf = fresh.register(core.CollKind.ALL_REDUCE,
                        fresh.communicator(range(3)), n_elems=n)
    for i, old in enumerate((0, 2, 3)):
        hf.submit(i, data=data[old])
    fresh.drive()
    outs = {r: h.read(r) for r in range(3)}
    for r in range(3):
        np.testing.assert_array_equal(outs[r], hf.read(r))
    assert int(rt.stats()["supersteps"].max()) == \
        int(fresh.stats()["supersteps"].max())
    outs["report"] = np.asarray([report[k] for k in (
        "n_ranks", "generation", "drain_launches", "replayed", "dropped")],
        np.float32)
    return rt, outs


def evict_two_level(core):
    """Two-level bucket at R=8, rank 5 dies, evict -> R=7 (prime: the
    replay re-derives hierarchy (7, 1)); bit-identical to a fresh 7-rank
    runtime, in no more relaunches."""
    R, n = 8, 64
    data = _payloads(R, n)
    rt = _rt(core, R)
    h = rt.register(core.CollKind.ALL_REDUCE,
                    rt.logical_communicator(range(R)), n_elems=n,
                    algo="two_level", hierarchy=(2, 4))
    for r in range(R):
        h.submit(r, data=data[r])
    rt.drive()
    launches_before = rt.launches
    for r in range(R):
        if r != 5:
            h.submit(r, data=data[r])
    report = rt.evict(5)
    assert report["n_ranks"] == 7 and report["replayed"] == 7 and h.alive
    assert rt.stats()["algos"][h.coll_id] == "two_level"
    fresh = _rt(core, 7)
    hf = fresh.register(core.CollKind.ALL_REDUCE,
                        fresh.logical_communicator(range(7)), n_elems=n,
                        algo="two_level")
    for i, old in enumerate(r for r in range(R) if r != 5):
        hf.submit(i, data=data[old])
    fresh.drive()
    outs = {r: h.read(r) for r in range(7)}
    for r in range(7):
        np.testing.assert_array_equal(outs[r], hf.read(r))
    assert (rt.launches - launches_before - report["drain_launches"]
            <= fresh.launches)
    assert int(rt.stats()["supersteps"].max()) == \
        int(fresh.stats()["supersteps"].max())
    return rt, outs


def double_evict(core):
    """R=5 -> 3 in two shrinks: handles keep resolving."""
    R, n = 5, 20
    data = _payloads(R, n)
    rt = _rt(core, R)
    h = rt.register(core.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    h.submit_all(data=data)
    rt.drive()
    rt.evict(1)
    rt.evict(2)                 # old rank 3
    assert rt.cfg.n_ranks == 3 and h.alive
    survivors = [0, 2, 4]
    h.submit_all(data={i: data[r] for i, r in enumerate(survivors)})
    rt.drive()
    outs = {r: h.read(r) for r in range(3)}
    np.testing.assert_array_equal(outs[0], sum(data[r] for r in survivors))
    return rt, outs


@pytest.mark.parametrize("scenario", [evict_flat, evict_two_level,
                                      double_evict],
                         ids=lambda f: f.__name__)
def test_evict_matches_reference(scenario):
    run_both(scenario)


def test_evict_replays_staged_but_unlaunched():
    R, n = 4, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    h = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    rt.state                    # build without launching (nothing flushed)
    for r in (0, 2, 3):
        h.submit(r, data=data[r])
    report = rt.evict(1)
    assert report["replayed"] == 3 and report["drain_launches"] >= 1
    for new_r in range(3):
        np.testing.assert_array_equal(h.read(new_r),
                                      data[0] + data[2] + data[3])


def test_evict_drops_dead_ranks_submissions_and_callbacks():
    R, n = 4, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    h = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    fired = []
    for r in (0, 1, 3):
        h.submit(r, data=data[r], callback=lambda rr, cc: fired.append(rr))
    report = rt.evict(3, relaunch=False)
    assert report["dropped"] == 1 and report["replayed"] == 2
    h.submit(2, data=data[2])
    rt.drive()
    assert sorted(fired) == [0, 1]
    np.testing.assert_array_equal(h.read(0), data[0] + data[1] + data[2])


def test_evicted_registration_raises():
    R, n = 4, 16
    rt = _rt(T, R)
    comm = rt.communicator(range(R))
    h_ar = rt.register(T.CollKind.ALL_REDUCE, comm, n_elems=n)
    h_bc = rt.register(T.CollKind.BROADCAST, comm, n_elems=n, root=2)
    data = _payloads(R, n)
    h_ar.submit_all(data=data)
    rt.drive()
    with pytest.warns(UserWarning, match="dissolved"):
        report = rt.evict(2)
    assert h_ar.alive and not h_bc.alive
    assert report["dissolved"] == [1]
    with pytest.raises(T.EvictionError):
        h_bc.submit(0, data=data[0])
    with pytest.raises(T.EvictionError):
        _ = h_bc.coll_id


def test_double_evict_rooted_broadcast_remaps_root():
    R, n = 5, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    h_bc = rt.register(T.CollKind.BROADCAST, rt.communicator(range(R)),
                       n_elems=n, root=3)
    h_bc.submit_all(data=data)
    rt.drive()
    rt.evict(1)
    rt.evict(0)
    assert rt.cfg.n_ranks == 3 and h_bc.alive
    h_bc.submit_all(data={i: data[r] for i, r in enumerate((2, 3, 4))})
    rt.drive()
    for new_r in range(3):
        np.testing.assert_array_equal(h_bc.read(new_r), data[3])


def test_second_evict_dissolves_renumbered_root():
    R, n = 4, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    comm = rt.communicator(range(R))
    h_ar = rt.register(T.CollKind.ALL_REDUCE, comm, n_elems=n)
    h_bc = rt.register(T.CollKind.BROADCAST, comm, n_elems=n, root=3)
    h_ar.submit_all(data=data)
    rt.drive()
    rt.evict(0)
    assert h_bc.alive
    with pytest.warns(UserWarning, match="BROADCAST.*dissolved"):
        rt.evict(2)
    assert h_ar.alive and not h_bc.alive


def test_dissolved_root_stays_dissolved_across_evicts():
    R, n = 5, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    comm = rt.communicator(range(R))
    h_ar = rt.register(T.CollKind.ALL_REDUCE, comm, n_elems=n)
    h_bc = rt.register(T.CollKind.BROADCAST, comm, n_elems=n, root=2)
    h_ar.submit_all(data=data)
    rt.drive()
    with pytest.warns(UserWarning, match="dissolved"):
        rt.evict(2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rt.evict(0)
    assert not [w for w in caught if "dissolved" in str(w.message)]
    assert rt.cfg.n_ranks == 3 and h_ar.alive and not h_bc.alive
    h_ar.submit_all(data={i: data[r] for i, r in enumerate((1, 3, 4))})
    rt.drive()
    np.testing.assert_array_equal(h_ar.read(0), data[1] + data[3] + data[4])


def test_evict_dissolves_flat_alltoall():
    R, n = 4, 12
    data = _payloads(R, n)
    rt = _rt(T, R)
    comm = rt.communicator(range(R))
    h_ar = rt.register(T.CollKind.ALL_REDUCE, comm, n_elems=n)
    h_a2a = rt.register(T.CollKind.ALL_TO_ALL, comm, n_elems=n)
    h_ar.submit_all(data=data)
    rt.drive()
    for r in (0, 2, 3):
        h_a2a.submit(r, data=data[r])
    with pytest.warns(UserWarning, match="ALL_TO_ALL.*dissolved"):
        report = rt.evict(1)
    assert h_ar.alive and not h_a2a.alive
    assert report["dissolved"] == [1] and report["replayed"] == 0


# ---------------------------------------------------------------------------
# detection -> diagnosis -> eviction
# ---------------------------------------------------------------------------

WINDOWS = [
    ({"rtc_latency": np.zeros((4, 2)), "rtc_events": np.zeros((4, 2))},),
    ({"rtc_latency": np.array([[4., 0], [4, 0], [4, 0], [0, 0]]),
      "rtc_events": np.array([[2., 0], [2, 0], [2, 0], [0, 0]])},),
    ({"rtc_latency": np.array([[9., 1], [40, 0], [8, 0], [0, 0]]),
      "rtc_events": np.array([[4., 1], [4, 0], [4, 0], [0, 0]])},),
]


def test_straggler_detector_matches_reference():
    """Both channels and explicit suspicion, window by window, against the
    reference detector on the same observations."""
    rng = np.random.RandomState(0)
    dets = (StragglerDetector(4), JDetector(4))
    for (stats,) in WINDOWS:
        times = {r: float(rng.rand()) + (3.0 if r == 1 else 0.0)
                 for r in range(4)}
        for det in dets:
            for r, t in times.items():
                det.observe(r, t)
            det.observe_collective_stats(stats)
        t, j = dets
        np.testing.assert_array_equal(t.ewma, j.ewma)
        np.testing.assert_array_equal(t.coll_ewma, j.coll_ewma)
        np.testing.assert_array_equal(t.suspect, j.suspect)
        assert t.stragglers() == j.stragglers()
        assert t.healthy_ranks() == j.healthy_ranks()
    assert dets[0].suspect[3] and 1 in dets[0].stragglers()


def controller_e2e(core, controller):
    """Kill rank 2 at R=6: the controller turns the DeadlockTimeout into a
    diagnosis, marks the holder suspect, evicts it and the replay
    completes on R=5."""
    R, n = 6, 24
    data = _payloads(R, n)
    rt = _rt(core, R)
    h = rt.register(core.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    ctl = controller(rt)
    for r in range(R):
        if r != 2:
            h.submit(r, data=data[r])
    with pytest.raises(core.DeadlockTimeout) as ei:
        rt.drive(max_launches=3)
    ctl.observe_step({r: 0.01 for r in range(R) if r != 2})
    assert ctl.diagnose_tenants()[0]["holding_ranks"] == [2]
    assert ctl.heal(ei.value) == [2] and rt.cfg.n_ranks == 5
    assert ctl.detector.n_ranks == 5
    outs = {r: h.read(r) for r in range(5)}
    for r in range(5):
        np.testing.assert_array_equal(
            outs[r], sum(v for k, v in data.items() if k != 2))
    return rt, outs


def test_reliability_controller_e2e():
    jrt, jo = controller_e2e(J, JController)
    trt, to = controller_e2e(T, ReliabilityController)
    for r in jo:
        np.testing.assert_array_equal(to[r], np.asarray(jo[r]))
    np.testing.assert_array_equal(trt.stats()["supersteps"],
                                  np.asarray(jrt.stats()["supersteps"]))


def test_heal_caps_evictions_to_keep_survivors():
    R, n = 4, 16
    data = _payloads(R, n)
    rt = _rt(T, R)
    h = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=n)
    h.submit_all(data=data)
    rt.drive()
    ctl = ReliabilityController(rt, min_survivors=2)
    for r in range(R):
        ctl.detector.mark_suspect(r)
    with pytest.warns(UserWarning, match="keeping suspect"):
        evicted = ctl.heal()
    assert evicted == [3, 2] and ctl.deferred == [0, 1]
    assert rt.cfg.n_ranks == 2 and h.alive
    h.submit_all(data={0: data[0], 1: data[1]})
    rt.drive()
    np.testing.assert_array_equal(h.read(0), data[0] + data[1])


def test_for_serving_reads_runtime_and_tenant_names():
    """``for_serving`` binds to any QoS object with ``runtime`` and
    ``class_of``; diagnosis names stalled chains by tenant."""
    rt = _rt(T, 2, max_comms=1)
    h = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(range(2)),
                    n_elems=16)

    class Qos:
        runtime = rt

        @staticmethod
        def class_of(cid):
            return "BACKGROUND" if cid == int(h) else None

    ctl = ReliabilityController.for_serving(Qos())
    h.submit(0, data=np.ones(16, np.float32))
    with pytest.raises(T.DeadlockTimeout):
        rt.drive(max_launches=2)
    (stall,) = ctl.diagnose_tenants()
    assert stall["tenant"] == "BACKGROUND" and stall["holding_ranks"] == [1]
