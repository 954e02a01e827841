"""The slice end to end: the port's ``OcclRuntime(cfg, device="cpu")``
against the reference ``OcclRuntime`` on identical submissions.

Outputs and the scheduler's counters (``supersteps``, ``preempts``,
``stall_slices``, ``stage_completions``, ``completed``) and the whole
flight-recorder export must be bitwise equal.  Cases: the quickstart
example's config and workload, a bfloat16 heap, a run that needs several
launches (small ``superstep_budget``), and PRIORITY with
``priority_preempts``.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

COUNTERS = ("supersteps", "preempts", "stall_slices", "stage_completions",
            "completed", "launch_steps", "epoch", "slices_moved",
            "qlen_at_fetch", "rtc_latency", "rtc_events", "cq_count",
            "barrier_supersteps", "tick_calls")
RECORD = ("kind", "coll", "step", "count", "kind_counts")


def runtime(core, **cfg_kw):
    cfg = core.OcclConfig(**cfg_kw)
    return core.OcclRuntime(cfg, device="cpu") if core is T \
        else core.OcclRuntime(cfg)


def assert_same_run(jrt, trt, outs_j, outs_t):
    """Outputs, counters and flight record of two runtimes, bitwise."""
    assert outs_j.keys() == outs_t.keys()
    for k in outs_j:
        want = np.asarray(outs_j[k]).astype(np.float32)
        np.testing.assert_array_equal(
            outs_t[k].view(np.uint32), want.view(np.uint32), err_msg=str(k))
    js, ts = jrt.stats(), trt.stats()
    for k in COUNTERS:
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    for k in RECORD:
        np.testing.assert_array_equal(ts["flight_recorder"][k],
                                      js["flight_recorder"][k], err_msg=k)
    assert trt.launches == jrt.launches
    assert trt.queues.outstanding() == jrt.queues.outstanding() == 0


def quickstart(core):
    """examples/quickstart.py: 4 ranks, parity-inverted submission order."""
    R = 4
    rt = runtime(core, n_ranks=R, max_colls=4, max_comms=1, slice_elems=64,
                 conn_depth=4, heap_elems=1 << 14)
    world = rt.communicator(list(range(R)))
    grads = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=1024)
    acts = rt.register(core.CollKind.ALL_GATHER, world, n_elems=512)
    rng = np.random.RandomState(0)
    g = [rng.randn(1024).astype(np.float32) for _ in range(R)]
    a = [rng.randn(128).astype(np.float32) for _ in range(R)]
    done = []
    for r in range(R):
        order = [(grads, g[r]), (acts, a[r])]
        if r % 2:
            order.reverse()
        for cid, data in order:
            rt.submit(r, cid, data=data,
                      callback=lambda rank, c: done.append((rank, c)))
    rt.drive()
    np.testing.assert_allclose(rt.read_output(0, grads), sum(g), rtol=1e-5)
    np.testing.assert_allclose(rt.read_output(3, acts), np.concatenate(a),
                               rtol=1e-5)
    assert len(done) == 2 * R
    outs = {(r, c): rt.read_output(r, c) for r in range(R)
            for c in (grads, acts)}
    return rt, outs, sorted(done)


def test_quickstart_matches_reference():
    jrt, jo, jdone = quickstart(J)
    trt, to, tdone = quickstart(T)
    assert tdone == jdone
    assert_same_run(jrt, trt, jo, to)
    ev = T.events(trt.export_flight_record())
    assert ev and {e.kind_name for e in ev} >= {"SUBMIT", "STAGE_DONE",
                                                "CQE"}


def mixed(core, **cfg_kw):
    """Four collectives of four kinds on two lanes (world ring + a 3-rank
    sub-ring), seeded per-rank orders, one priority class per collective
    and iteration, two iterations."""
    R = 4
    rt = runtime(core, n_ranks=R, max_colls=4, max_comms=2, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 13, **cfg_kw)
    a = rt.communicator(list(range(R)))
    b = rt.communicator([1, 2, 3])
    K = core.CollKind
    regs = [(K.ALL_REDUCE, a, 200, 0), (K.REDUCE_SCATTER, b, 90, 0),
            (K.BROADCAST, a, 120, 2), (K.REDUCE, b, 70, 1)]
    ids = [rt.register(k, c, n_elems=n, root=root, op=i % 4)
           for i, (k, c, n, root) in enumerate(regs)]
    rng = np.random.RandomState(21)
    outs = {}
    for it in range(2):
        prio = rng.randint(0, 4, len(ids))
        for r in range(R):
            for i in rng.permutation(len(ids)):
                kind, comm, n, _ = regs[i]
                if r not in comm.members:
                    continue
                rt.submit(r, ids[i], prio=int(prio[i]),
                          data=rng.randn(n).astype(np.float32))
        rt.drive(max_launches=256)
        outs.update({(it, r, c): rt.read_output(r, c) for r in range(R)
                     for c in ids
                     if r in rt.specs[c].comm.members})
    return rt, outs


@pytest.mark.parametrize("case,kw", [
    ("bf16", dict(dtype="bfloat16", burst_slices=2)),
    ("budget", dict(superstep_budget=24, quit_threshold=24)),
    ("priority", dict(order_policy=T.OrderPolicy.PRIORITY,
                      priority_preempts=True, burst_slices=2)),
])
def test_mixed_workload_matches_reference(case, kw):
    jrt, jo = mixed(J, **kw)
    trt, to = mixed(T, **kw)
    assert_same_run(jrt, trt, jo, to)
    st = trt.stats()
    if case == "budget":
        assert trt.launches > 2
        assert all(h["launch_steps"] <= 24 for h in trt.launch_history)
    if case == "priority":
        assert int(st["preempts"].sum()) > 0


def all_to_all(core):
    """Flat-ring ALL_TO_ALL and ALL_TO_ALL_RAGGED (per-distance sizes) on
    one lane, parity-inverted submission order."""
    R = 4
    rt = runtime(core, n_ranks=R, max_colls=2, max_comms=1, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 13, burst_slices=2)
    world = rt.communicator(list(range(R)))
    dense = rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=96)
    ragged = rt.register(core.CollKind.ALL_TO_ALL_RAGGED, world, n_elems=80,
                         chunk_sizes=[20, 3, 0, 17])
    rng = np.random.RandomState(3)
    xs = {}
    for r in range(R):
        for c, n in ([(dense, 96), (ragged, 40)] if r % 2
                     else [(ragged, 40), (dense, 96)]):
            xs[(r, c)] = rng.randn(n).astype(np.float32)
            rt.submit(r, c, data=xs[(r, c)])
    rt.drive()
    outs = {(r, c): rt.read_output(r, c) for r in range(R)
            for c in (dense, ragged)}
    g = 96 // R        # dense: output chunk o of rank m is input chunk m of o
    for m in range(R):
        for o in range(R):
            np.testing.assert_array_equal(
                outs[(m, dense)][o * g:(o + 1) * g],
                xs[(o, dense)][m * g:(m + 1) * g])
    return rt, outs


def test_all_to_all_matches_reference():
    jrt, jo = all_to_all(J)
    trt, to = all_to_all(T)
    assert_same_run(jrt, trt, jo, to)
