"""Composite-collective demo: hierarchical two-level all-reduce via
device-chained sub-collectives.

Three acts:

1. **Flat vs two-level registration** -- the same logical all-reduce over a
   4x4 rank grid registered both ways; the two-level lowering (intra-group
   reduce-scatter -> inter-group all-reduce over chunk owners ->
   intra-group all-gather) completes in ~half the supersteps because its
   latency term is N + (2G - 1) + N = 15 primitive steps instead of the
   ring's 2R - 1 = 31.  The chain advances ON DEVICE: one daemon launch
   runs all three stages, observable in the stats() chain/stage counters.

2. **Auto selection** -- ``algo="auto"`` ranks the registered candidate
   plans (ring / two_level / torus / hybrid for all-reduce) with the
   measured alpha-beta-gamma cost model (``core/costmodel.py``; the port
   reads ``BENCH_torch_calibration.json``, the card's fit, or the file
   ``REPRO_TORCH_CALIBRATION`` names), so its picks follow that fit.

3. **The adversarial chained-order scenario** -- two chains share the
   derived intra/inter lanes and the ranks submit them in conflicting
   orders.  The static single-FIFO-queue baseline deadlocks on this order
   set; OCCL's preemption completes both chains -- composed collectives
   stay deadlock-free, not just independently submitted ones.

Port of ``examples/hierarchical_allreduce.py``.

    python -m repro_torch.examples.hierarchical_allreduce [--device cpu]
"""
from __future__ import annotations

import numpy as np

from ..core import CollKind, OcclConfig, OcclRuntime, run_static_order
from ..core.state import resolve_device
from . import arg_parser, fabric_totals

R, HIER, N_ELEMS = 16, (4, 4), 2048
LANES = dict(n_ranks=R, max_colls=8, max_comms=3, slice_elems=64,
             conn_depth=24, burst_slices=8, heap_elems=1 << 17,
             superstep_budget=1 << 15)


def make_runtime(device):
    rt = OcclRuntime(OcclConfig(**LANES), device=device)
    return rt, rt.communicator(list(range(R)))


def drive_once(rt, cid, xs):
    for r in range(R):
        rt.submit(r, cid, data=xs[r])
    s0 = int(np.asarray(rt.stats()["supersteps"]).max())
    rt.drive()
    return int(np.asarray(rt.stats()["supersteps"]).max()) - s0


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(42)
    res, stats = {}, []

    # --- 1. flat ring vs two-level chain --------------------------------
    xs = [rng.randn(N_ELEMS).astype(np.float32) for _ in range(R)]
    want = np.sum(xs, axis=0)
    steps = {}
    for algo in ("ring", "two_level"):
        rt, world = make_runtime(device)
        cid = rt.register(CollKind.ALL_REDUCE, world, n_elems=N_ELEMS,
                          algo=algo, hierarchy=HIER)
        drive_once(rt, cid, xs)                # warmup: converge
        steps[algo] = drive_once(rt, cid, xs)
        outs = rt.read_outputs_bulk([(r, cid) for r in range(R)])
        for r in range(R):
            np.testing.assert_allclose(outs[(r, cid)], want,
                                       rtol=1e-4, atol=1e-4)
        st = rt.stats()
        stats.append(st)
        if algo == "two_level":
            chain = st["chains"][cid]
            res.update(
                chain=list(chain),
                stage_completions=st["stage_completions"][:, chain]
                .sum(axis=0).tolist(),
                logical_cqes=st["completed"][:, chain].sum(axis=0).tolist())
            print(f"two-level chain stages {chain}: per-stage completions "
                  f"{res['stage_completions']}, logical CQEs only at the "
                  f"tail {res['logical_cqes']}")
    res["steps"] = steps
    print(f"supersteps per all-reduce at R={R}: flat ring {steps['ring']}, "
          f"two-level {steps['two_level']} "
          f"({steps['ring'] / steps['two_level']:.1f}x fewer)")
    assert steps["two_level"] < steps["ring"]

    # --- 2. cost-model auto selection -----------------------------------
    # Under the bandwidth-skew lane model (4 islands, inter lanes capped at
    # 2 slices/superstep) the flat ring pays the inter cap on EVERY hop;
    # which plan wins at each payload is the fitted model's call.
    rt = OcclRuntime(OcclConfig(**LANES, bandwidth_groups=4,
                                inter_burst_cap=2), device=device)
    world = rt.communicator(list(range(R)))
    small = rt.register(CollKind.ALL_REDUCE, world, n_elems=64, algo="auto")
    big = rt.register(CollKind.ALL_REDUCE, world, n_elems=1 << 16,
                      algo="auto")
    algos = rt.stats()["algos"]
    res["auto"] = {64: algos.get(small, "ring"),
                   1 << 16: algos.get(big, "ring")}
    print(f"auto selection under bandwidth skew: 64 elems -> "
          f"{res['auto'][64]}, {1 << 16} elems -> {res['auto'][1 << 16]}")

    # --- 3. adversarial chained submission orders -----------------------
    orders = {r: [0, 1] if r % 2 == 0 else [1, 0] for r in range(R)}
    static = run_static_order(orders, {c: list(range(R)) for c in range(2)})
    print("static single-FIFO-queue baseline on the conflicting orders:",
          "DEADLOCK" if static.deadlocked else "ok",
          f"(wait-for cycle over ranks {static.cycle})")
    assert static.deadlocked
    res["static"] = {"deadlocked": static.deadlocked,
                     "cycle": list(static.cycle)}

    rt, world = make_runtime(device)
    a = rt.register(CollKind.ALL_REDUCE, world, n_elems=512,
                    algo="two_level", hierarchy=HIER)
    b = rt.register(CollKind.ALL_REDUCE, world, n_elems=384,
                    algo="two_level", hierarchy=HIER)
    data = {c: [rng.randn(n).astype(np.float32) for _ in range(R)]
            for c, n in [(a, 512), (b, 384)]}
    for r in range(R):
        for slot in orders[r]:
            cid = [a, b][slot]
            rt.submit(r, cid, data=data[cid][r])
    rt.drive(max_launches=128)
    outs = rt.read_outputs_bulk([(r, c) for c in (a, b) for r in range(R)])
    for cid in (a, b):
        w = np.sum(data[cid], axis=0)
        for r in range(R):
            np.testing.assert_allclose(outs[(r, cid)], w,
                                       rtol=1e-4, atol=1e-4)
    st = rt.stats()
    stats.append(st)
    res.update(preempts=int(st["preempts"].sum()), launches=rt.launches,
               fabric=fabric_totals(*stats))
    print(f"OCCL: both chains complete under conflicting orders — "
          f"{res['preempts']} preemptions, {res['launches']} daemon "
          "launches")
    print("OK — composed collectives are deadlock-free, not just "
          "independently submitted ones.")
    return res


if __name__ == "__main__":
    main()
