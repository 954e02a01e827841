"""End-to-end driver: data-parallel training with OCCL gradient sync
(paper Sec. 5.3 protocol) -- a 64M-param qwen3-family model, with
checkpoints, fault injection, and recovery.

First a fault-tolerant single-process loop (``TrainController``: async
checkpoints every 25 steps, a failure injected before step 40, recovery
from the last checkpoint), then DP ranks whose gradients are averaged by
``OcclGradSync`` every step.  Port of ``examples/train_dp_occl.py``; the
checkpoints go to a temporary directory under the checkout's ``build/``.

Reduce steps/size via flags for a quick run:

    python -m repro_torch.examples.train_dp_occl --steps 12 --tiny \\
        [--device cpu]
"""
from __future__ import annotations

import dataclasses
import pathlib
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ShapeCell
from ..core.state import resolve_device
from ..data.pipeline import SyntheticPipeline
from ..fabric.ft import FTConfig, TrainController
from ..train.occl_sync import OcclGradSync
from ..train.state import init_state
from ..train.step import make_apply_step, make_grads_step, make_train_step
from ..tree import tree_leaves
from . import arg_parser, fabric_totals

BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"


def model_config(tiny: bool):
    """qwen3-0.6b reduced (``--tiny``), else the reference's 64M-param
    width: d_model 512, 8 layers, d_ff 2048, 8 / 4 heads of 64, a 32000
    vocabulary."""
    cfg = get_config("qwen3-0.6b").reduced()
    if tiny:
        return cfg
    return dataclasses.replace(cfg, d_model=512, n_layers=8, d_ff=2048,
                               n_heads=8, n_kv_heads=4, d_head=64,
                               vocab=32000)


def parse_args(argv=None):
    ap = arg_parser(__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--dp-steps", type=int, default=None,
                    help="steps of the OCCL-synced DP loop (default: the "
                    "reference's min(--steps, 30))")
    return ap.parse_args(argv)


def ft_loop(cfg, cell, steps: int, device) -> dict:
    """The fault-tolerant loop: ``min(steps, 60)`` steps, a failure before
    step ``min(40, steps // 2)``."""
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD, prefix="ckpt_") as ckdir:
        pipe = SyntheticPipeline(cfg, cell).start()
        ctrl = TrainController(
            FTConfig(ckpt_dir=ckdir, ckpt_period=25),
            make_train_step(cfg), init_state(cfg, device=device), pipe,
            inject_failure_at=min(40, steps // 2) or None)
        try:
            logs = ctrl.run(min(steps, 60))
        finally:
            pipe.stop()
    print(f"[ft loop] {len(logs)} steps, {ctrl.restarts} recovery, "
          f"loss {logs[0]['loss']:.3f} -> {logs[-1]['loss']:.3f}")
    return {"steps": [m["step"] for m in logs],
            "losses": [m["loss"] for m in logs],
            "step_ms": [m["step_time_s"] * 1e3 for m in logs],
            "restarts": ctrl.restarts}


def dp_loop(cfg, cell, dp: int, steps: int, device) -> tuple[dict, dict]:
    """``steps`` DP steps: per-rank grads, the OCCL all-reduce, the
    update; returns its counts and host-clock times (``step_s`` per step,
    ``sync_s`` the all-reduce's part, the first including the sync's
    set-up) and the sync runtime's stats."""
    states = [init_state(cfg, device=device) for _ in range(dp)]
    pipes = [SyntheticPipeline(cfg, cell, shard_id=r, n_shards=dp)
             for r in range(dp)]
    gfn = make_grads_step(cfg)
    afn = make_apply_step(cfg)
    sync = None
    mean_losses, step_s, sync_s = [], [], []
    t0 = time.perf_counter()
    for step in range(steps):
        t1 = time.perf_counter()
        per_rank, losses = [], []
        for r in range(dp):
            loss, g = gfn(states[r], next(pipes[r]))
            per_rank.append(g)
            losses.append(float(loss))
        if sync is None:
            sync = OcclGradSync(per_rank[0], dp, bucket_elems=1 << 16,
                                slice_elems=1024, device=device)
        t2 = time.perf_counter()
        synced = sync.all_reduce(per_rank)
        sync_s.append(time.perf_counter() - t2)
        states = [afn(states[r], synced[r]) for r in range(dp)]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t1)
        mean_losses.append(float(np.mean(losses)))
        if step % 5 == 0:
            print(f"[occl dp] step {step:3d} loss {mean_losses[-1]:.4f}")
    dt = time.perf_counter() - t0
    st = sync.stats()
    res = {"steps": steps, "buckets": len(sync.buckets),
           "supersteps": int(st["supersteps"].max()),
           "losses": mean_losses, "step_s": step_s, "sync_s": sync_s,
           "seconds": dt,
           "samples_per_s": steps * cell.global_batch / dt}
    print(f"[occl dp] {steps} steps in {dt:.1f}s "
          f"({res['samples_per_s']:.1f} samples/s); "
          f"buckets={res['buckets']}, "
          f"daemon supersteps={res['supersteps']}")
    return res, st


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(args.tiny)
    cell = ShapeCell("ex", 128, 4 * args.dp, "train")

    leaves = tree_leaves(init_state(cfg, device="meta").params)
    n = sum(p.numel() for p in leaves)
    print(f"model: {cfg.name} ({n/1e6:.1f}M params), DP={args.dp}")

    ft = ft_loop(cfg, cell, args.steps, device)
    dp_steps = (min(args.steps, 30) if args.dp_steps is None
                else args.dp_steps)
    dp, st = dp_loop(cfg, cell, args.dp, dp_steps, device)
    print("OK")
    return {"params": n, "leaves": len(leaves), "dp": args.dp, "ft": ft,
            "dp_loop": dp, "fabric": fabric_totals(st)}


if __name__ == "__main__":
    main()
