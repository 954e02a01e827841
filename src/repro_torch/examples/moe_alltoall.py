"""Expert-parallel MoE dispatch through OCCL all-to-all.

Three acts:

1. **Flat relay ring vs two-level chain** -- the same personalized
   exchange over a 4x4 rank grid registered both ways.  The flat ring
   pays the O(R^2) relay program (1 + (R-1)(R+2)/2 = 136 primitive steps
   at R=16: every granule rides the ring to its destination through
   RECV_SEND relay hops), while the two-level lowering runs two short
   full-membership exchanges (intra-island, then inter-island over
   transposed granules) for ~20 steps -- and lands the IDENTICAL output
   layout, element-exact.

2. **MoE dispatch/combine** -- a reduced DeepSeek-MoE block runs expert-
   parallel: each rank owns a contiguous expert shard, tokens are routed
   top-k, packed into uniform per-(source, expert) capacity bins, and
   both the dispatch and combine exchanges ride staged OCCL all-to-all
   submits.  The transport is bit-preserving in float32, so the OCCL
   path must match the direct-indexing reference BITWISE -- including
   under real capacity drops, where overflow slots travel as zeros.

3. **The adversarial chained-order scenario** -- two MoE layers' worth of
   dispatch/combine exchanges submitted in conflicting per-rank orders.
   The static single-FIFO-queue baseline deadlocks on this order set
   (wait-for cycle); OCCL's preemption drains all of them with every
   personalized granule landing reference-exact.

Port of ``examples/moe_alltoall.py``.

    python -m repro_torch.examples.moe_alltoall [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..core import CollKind, OcclConfig, OcclRuntime, run_static_order
from ..core.primitives import program_len
from ..core.state import resolve_device
from ..models.moe import init_moe_block
from ..train.occl_moe import OcclMoE, ep_forward_ref
from . import arg_parser, fabric_totals

R, HIER, N_ELEMS = 16, (4, 4), 2048
EP, TL = 4, 8


def make_runtime(device):
    cfg = OcclConfig(n_ranks=R, max_colls=8, max_comms=4, slice_elems=64,
                     conn_depth=32, burst_slices=8, heap_elems=1 << 18,
                     superstep_budget=1 << 15)
    rt = OcclRuntime(cfg, device=device)
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

    # --- 1. flat relay ring vs two-level chain --------------------------
    xs = [np.asarray(rng.randn(N_ELEMS), np.float32) for _ in range(R)]
    c = N_ELEMS // R
    want = {m: np.concatenate([xs[o][m * c:(m + 1) * c] for o in range(R)])
            for m in range(R)}
    steps = {}
    for algo in ("ring", "two_level"):
        rt, world = make_runtime(device)
        cid = rt.register(CollKind.ALL_TO_ALL, world, n_elems=N_ELEMS,
                          algo=algo, hierarchy=HIER)
        drive_once(rt, cid, xs)                # warmup: converge
        steps[algo] = drive_once(rt, cid, xs)
        outs = rt.read_outputs_bulk([(m, cid) for m in range(R)])
        for m in range(R):
            np.testing.assert_array_equal(outs[(m, cid)], want[m])
        stats.append(rt.stats())
    res.update(program_len=program_len(CollKind.ALL_TO_ALL, R), steps=steps)
    print(f"all-to-all at R={R}: flat relay-ring program is "
          f"{res['program_len']} primitive steps, "
          f"supersteps flat {steps['ring']} vs two-level "
          f"{steps['two_level']} ({steps['ring'] / steps['two_level']:.1f}x "
          "fewer), outputs element-exact either way")
    assert steps["two_level"] < steps["ring"]

    # --- 2. expert-parallel MoE dispatch/combine through OCCL -----------
    mcfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                               capacity_factor=8.0)
    params = init_moe_block(0, "t", mcfg, torch.float32, device)
    toks = [torch.from_numpy((rng.randn(TL, mcfg.d_model) * 0.5)
                             .astype(np.float32)).to(device)
            for _ in range(EP)]
    res["moe"] = {}
    for cap, label in [(TL * mcfg.top_k, "no-drop"), (4, "capacity-dropped")]:
        moe = OcclMoE(mcfg, EP, TL, cap=cap, device=device)
        ys = moe.forward(params, toks)
        ref = ep_forward_ref(mcfg, params, toks, cap=cap)
        for r in range(EP):
            np.testing.assert_array_equal(ys[r].cpu().numpy(),
                                          ref[r].cpu().numpy())
        stats.append(moe.stats())
        res["moe"][label] = {"cap": cap, "bitwise": True}
        print(f"MoE {label} (E={mcfg.n_experts}, top_k={mcfg.top_k}, "
              f"cap={cap}): OCCL dispatch+combine BITWISE == reference "
              f"on all {EP} ranks")

    # --- 3. adversarial chained dispatch/combine orders -----------------
    C = 4                                      # two layers x (disp, comb)
    orders = {r: list(np.random.RandomState(r).permutation(C))
              for r in range(R)}
    static = run_static_order(orders, {i: list(range(R)) for i in range(C)})
    print("static single-FIFO-queue baseline on the conflicting orders:",
          "DEADLOCK" if static.deadlocked else "ok",
          f"(wait-for cycle over ranks {static.cycle})")
    assert static.deadlocked
    res["static"] = {"deadlocked": static.deadlocked,
                     "cycle": list(static.cycle)}

    rt, world = make_runtime(device)
    ids = [rt.register(CollKind.ALL_TO_ALL, world, n_elems=512)
           for _ in range(C)]
    data = {i: [np.asarray(rng.randn(512), np.float32) for _ in range(R)]
            for i in range(C)}
    for r in range(R):
        for slot in orders[r]:
            rt.submit(r, ids[slot], data=data[slot][r])
    rt.drive(max_launches=256)
    outs = rt.read_outputs_bulk([(m, i) for i in ids for m in range(R)])
    cc = 512 // R
    for i in range(C):
        for m in range(R):
            w = np.concatenate([data[i][o][m * cc:(m + 1) * cc]
                                for o in range(R)])
            np.testing.assert_array_equal(outs[(m, ids[i])], w)
    st = rt.stats()
    stats.append(st)
    res.update(preempts=int(st["preempts"].sum()), launches=rt.launches,
               fabric=fabric_totals(*stats))
    print(f"OCCL: all {C} chained exchanges complete under conflicting "
          f"orders — {res['preempts']} preemptions, {res['launches']} "
          "daemon launches, every granule reference-exact")
    print("OK — expert-parallel dispatch stays deadlock-free even when "
          "layers' exchanges interleave across ranks.")
    return res


if __name__ == "__main__":
    main()
