"""Compute-communication overlap inside the training step.

Two timelines for the SAME dense DP training step (backward + bucketized
gradient all-reduce), built on the tick contract (``core/daemon.py``):

1. **Barrier** -- the backward runs to completion, then every gradient
   bucket's all-reduce supersteps execute in one exposed drain (the
   ``ticks_per_boundary=0`` degenerate of ``make_overlap_grads_step``,
   structurally the classic "backward, then sync" step).
2. **Overlapped** -- ``autograd.Function`` boundaries submit each bucket
   the moment its gradients materialize MID-BACKWARD and spend a bounded
   ``tick(state, k)`` budget advancing the daemon; those supersteps hide
   behind the remaining backward compute, and only the drain tail stays
   exposed on the critical path.

Both produce the same gradients (the daemon schedule is identical work,
reordered against compute).  The demo prints the superstep ledger --
total / hidden / exposed -- and an ASCII timeline of where communication
sat, then repeats the story for the stream-sharded MoE layer (expert FFN
starting on arrived dispatch shards while later shard tails are still in
flight).  Port of ``examples/overlap_training.py``; the reference's script
stops in act 2, where its overlapped MoE forward is not bitwise equal to
its own ``ep_forward_ref``: this port holds that forward to a tolerance.

    python -m repro_torch.examples.overlap_training [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ShapeCell
from ..core.state import resolve_device
from ..data.pipeline import SyntheticPipeline
from ..models.moe import init_moe_block
from ..train.occl_moe import OcclMoE, ep_forward_ref
from ..train.occl_sync import OcclGradSync, static_all_reduce
from ..train.state import init_state
from ..train.step import make_grads_step, make_overlap_grads_step
from ..tree import tree_leaves
from . import arg_parser, fabric_totals

# forward_overlapped against ep_forward_ref (tests/test_torch_moe.py's
# tolerance): its batched expert product may sum in another order than the
# per-rank one, so the two differ by float32 rounding (outputs ~1e-4).
OVERLAP_CLOSE = dict(rtol=1e-5, atol=1e-9)


def ledger(sync_or_moe, before, label):
    """Print one forward's or step's supersteps split into hidden and
    exposed ones; returns ``(stats after, counts)``."""
    after = sync_or_moe.stats()
    total = int(np.max(after["supersteps"] - before["supersteps"]))
    hidden = int(np.max(after["overlap_supersteps"]
                        - before["overlap_supersteps"]))
    exposed = int(np.max(after["barrier_supersteps"]
                         - before["barrier_supersteps"]))
    bar = lambda n, ch: ch * max(0, round(40 * n / max(total, 1)))
    print(f"  {label:<10} supersteps={total:<5d} hidden={hidden:<5d} "
          f"exposed={exposed}")
    print(f"    compute  |{'#' * 40}|")
    print(f"    comm     |{bar(hidden, '~')}{bar(exposed, 'X')}|   "
          "(~ hidden behind compute, X exposed on the critical path)")
    return after, {"supersteps": total, "hidden": hidden, "exposed": exposed}


def dense_act(device) -> tuple[dict, dict]:
    """Act 1: the dense grad sync, barrier then overlapped."""
    print("=== dense DP grad sync: barrier vs overlapped backward ===")
    dp = 2
    cfg = get_config("qwen3-0.6b").reduced()
    cell = ShapeCell("t", 16, dp, "train")
    states = [init_state(cfg, device=device) for _ in range(dp)]
    batches = [SyntheticPipeline(cfg, cell, shard_id=r,
                                 n_shards=dp).batch_at(0) for r in range(dp)]
    gfn = make_grads_step(cfg)
    sync = OcclGradSync(init_state(cfg, device="meta").params, dp,
                        bucket_elems=16384, slice_elems=512,
                        burst_slices=8, bandwidth_groups=2,
                        intra_burst_cap=8, inter_burst_cap=2, device=device)
    print(f"{len(sync.buckets)} gradient buckets over {dp} ranks, "
          "skewed lanes (inter cap 2/8)")
    res = {"buckets": len(sync.buckets), "n_ranks": dp}

    params_list = [s.params for s in states]
    snap = sync.stats()
    for label, k in (("barrier", 0), ("overlapped", 8)):
        step = make_overlap_grads_step(cfg, sync, ticks_per_boundary=k)
        st, losses, grads = step(sync.occl.state, params_list, batches)
        sync.occl.adopt_state(st)
        snap, res[label] = ledger(sync, snap, label)

    # gradients are exact either way
    want = static_all_reduce([gfn(states[r], batches[r])[1]
                              for r in range(dp)])
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(want[0])):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)
    print("  gradients match the static all-reduce baseline\n")
    return res, snap


def moe_act(device) -> tuple[dict, dict]:
    """Act 2: the MoE layer, full-layer barrier then stream shards."""
    print("=== expert-parallel MoE: full-layer barrier vs stream shards ===")
    mcfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                               capacity_factor=8.0)
    params = init_moe_block(0, "t", mcfg, torch.float32, device)
    rng = np.random.RandomState(7)
    R, Tl = 4, 8
    cap = Tl * mcfg.top_k
    xs = [torch.from_numpy((rng.randn(Tl, mcfg.d_model) * 0.5)
                           .astype(np.float32)).to(device)
          for _ in range(R)]
    moe = OcclMoE(mcfg, R, Tl, cap=cap, n_streams=4, overlap_ticks=8,
                  device=device)
    print(f"{mcfg.n_experts} experts over {R} ranks, capacity {cap} split "
          f"into {moe.n_streams} dispatch/combine streams")
    res = {}
    snap = moe.stats()
    ys_b = moe.forward(params, xs)             # host-driven, all-barrier
    snap, res["barrier"] = ledger(moe, snap, "barrier")
    ys_o = moe.forward_overlapped(params, xs)  # one step on the device API
    snap, res["overlapped"] = ledger(moe, snap, "overlapped")

    ref = ep_forward_ref(mcfg, params, xs, cap=cap)
    for r in range(R):
        np.testing.assert_array_equal(ys_b[r].cpu().numpy(),
                                      ref[r].cpu().numpy())
        np.testing.assert_allclose(ys_o[r].cpu().numpy(),
                                   ref[r].cpu().numpy(), **OVERLAP_CLOSE)
    res["overlap_max_abs_diff"] = max(float((a - b).abs().max())
                                      for a, b in zip(ys_o, ref))
    print(f"  barrier path BIT-IDENTICAL to the expert-parallel reference; "
          f"overlapped path within {res['overlap_max_abs_diff']:.3g} of it "
          f"(rtol {OVERLAP_CLOSE['rtol']:g}, atol {OVERLAP_CLOSE['atol']:g})")
    return res, snap


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    dense, dense_stats = dense_act(device)
    moe, moe_stats = moe_act(device)
    return {"dense": dense, "moe": moe,
            "fabric": fabric_totals(dense_stats, moe_stats)}


if __name__ == "__main__":
    main()
