"""The paper's headline demo (Sec. 5.2): a workload that DEADLOCKS every
statically-sequenced collective library completes under OCCL.

8 ranks submit 8 all-reduces in pairwise-different orders, 3 iterations.
First we prove the baseline deadlocks (wait-for-graph cycle), then OCCL
runs it to completion, reporting the preemption counts that did the work.
Port of ``examples/adversarial_orders.py``.

    python -m repro_torch.examples.adversarial_orders [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from ..core import CollKind, OcclConfig, OcclRuntime, run_static_order
from ..core.state import resolve_device
from . import arg_parser, fabric_totals

R, C, ITERS = 8, 8, 3


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(42)
    orders = {r: list(rng.permutation(C)) for r in range(R)}

    # --- 1. the statically-sequenced baseline deadlocks -----------------
    static = run_static_order(orders, {c: list(range(R)) for c in range(C)})
    print("static single-FIFO-queue execution:",
          "DEADLOCK" if static.deadlocked else "ok")
    print("  completed before wedging:", static.completed)
    print("  wait-for cycle over ranks:", static.cycle)
    assert static.deadlocked

    # --- 2. OCCL completes the same workload ----------------------------
    cfg = OcclConfig(n_ranks=R, max_colls=C, max_comms=1, slice_elems=64,
                     conn_depth=4, heap_elems=1 << 16,
                     superstep_budget=1 << 15)
    rt = OcclRuntime(cfg, device=device)
    world = rt.communicator(list(range(R)))
    sizes = [64 << (i % 5) for i in range(C)]
    ids = [rt.register(CollKind.ALL_REDUCE, world, n_elems=s) for s in sizes]

    t0 = time.perf_counter()
    for it in range(ITERS):
        data = {i: [rng.randn(sizes[i]).astype(np.float32)
                    for _ in range(R)] for i in range(C)}
        for r in range(R):
            for slot in orders[r]:
                rt.submit(r, ids[slot], data=data[slot][r])
        rt.drive()
        outs = rt.read_outputs_bulk([(r, ids[i]) for i in range(C)
                                     for r in range(R)])
        for i in range(C):
            want = sum(data[i])
            for r in range(R):
                np.testing.assert_allclose(outs[(r, ids[i])], want,
                                           rtol=1e-4, atol=1e-5)
        print(f"iteration {it}: all {C} collectives correct on all {R} "
              "ranks")
    seconds = time.perf_counter() - t0

    st = rt.stats()
    res = {"static": {"deadlocked": static.deadlocked,
                      "completed": list(static.completed),
                      "cycle": list(static.cycle)},
           "completed": int(st["completed"].sum()),
           "preempts": int(st["preempts"].sum()),
           "launches": rt.launches,
           "supersteps": int(st["supersteps"].max()),
           "seconds": seconds, "fabric": fabric_totals(st)}
    print(f"\nOCCL: {res['completed']} collective executions, "
          f"{res['preempts']} preemptions (context switches), "
          f"{res['launches']} daemon launches")
    print("OK — the deadlock-prone workload is just a workload now.")
    return res


if __name__ == "__main__":
    main()
