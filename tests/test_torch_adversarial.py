"""The paper's headline demo on the port: ``examples/adversarial_orders.py``
(R=8, 8 all-reduces submitted in seeded pairwise-different orders, three
iterations) through the port's runtime against the reference's, bitwise,
with ``run_static_order`` reporting the same deadlock cycle in both."""
import numpy as np

import repro.core as J
import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

R, C, ITERS = 8, 8, 3


def adversarial(core):
    rng = np.random.RandomState(42)
    orders = {r: list(rng.permutation(C)) for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in range(C)})
    cfg = core.OcclConfig(n_ranks=R, max_colls=C, max_comms=1,
                          slice_elems=64, conn_depth=4, heap_elems=1 << 16,
                          superstep_budget=1 << 15)
    rt = (core.OcclRuntime(cfg, device="cpu") if core is T
          else core.OcclRuntime(cfg))
    world = rt.communicator(list(range(R)))
    sizes = [64 << (i % 5) for i in range(C)]
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=s)
           for s in sizes]
    outs, steps = {}, []
    for it in range(ITERS):
        data = {i: [rng.randn(sizes[i]).astype(np.float32)
                    for _ in range(R)] for i in range(C)}
        for r in range(R):
            for slot in orders[r]:
                rt.submit(r, ids[slot], data=data[slot][r])
        rt.drive()
        for i in range(C):
            want = sum(data[i])
            for r in range(R):
                got = rt.read_output(r, ids[i])
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
                outs[(it, r, i)] = np.asarray(got)
        steps.append(int(rt.stats()["supersteps"].max()))
    return static, rt, outs, steps


def test_adversarial_orders_match_reference():
    js, jrt, jo, jsteps = adversarial(J)
    ts, trt, to, tsteps = adversarial(T)
    assert js.deadlocked and ts.deadlocked
    assert (ts.cycle, ts.blocked_at, ts.completed) == \
        (js.cycle, js.blocked_at, js.completed)
    assert tsteps == jsteps
    for k in jo:
        np.testing.assert_array_equal(to[k].view(np.uint32),
                                      jo[k].view(np.uint32), err_msg=str(k))
    jst, tst = jrt.stats(), trt.stats()
    for k in ("supersteps", "preempts", "stall_slices", "stage_completions",
              "completed"):
        np.testing.assert_array_equal(tst[k], np.asarray(jst[k]), err_msg=k)
    for k in ("kind", "coll", "step", "count", "kind_counts"):
        np.testing.assert_array_equal(tst["flight_recorder"][k],
                                      jst["flight_recorder"][k], err_msg=k)
    assert int(tst["preempts"].sum()) > 0
    assert int(tst["completed"].sum()) == ITERS * C * R
