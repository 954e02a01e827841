"""Training launcher (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch vit-base \\
        --occl-sync --dp 4 --batch 128 --steps 2 [--device cpu]

``--occl-sync`` trains simulated DP ranks (the sim backend: all on one
device) with gradient buckets synchronized through the OCCL runtime (paper
Sec. 5.3); the defaults of ``--bucket-elems`` / ``--slice-elems`` /
``--burst-slices`` are the reference's.  The default path (the
fault-tolerant ``TrainController`` with checkpoints) is not ported yet and
raises ``NotImplementedError`` (ROADMAP.md, "Modules to port", item 8:
``checkpoint/ckpt.py`` and ``fabric/ft.py::TrainController``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..tree import tree_leaves


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--occl-sync", action="store_true")
    ap.add_argument("--dp", type=int, default=2,
                    help="simulated DP ranks for --occl-sync")
    ap.add_argument("--bucket-elems", type=int, default=4096)
    ap.add_argument("--slice-elems", type=int, default=256)
    ap.add_argument("--burst-slices", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..configs import get_config
    from ..configs.base import ShapeCell
    from ..core.state import resolve_device
    from ..train.state import init_state

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cell = ShapeCell("cli", args.seq, args.batch, "train")
    device = resolve_device(args.device)
    n = sum(int(np.prod(p.shape)) for p in
            tree_leaves(init_state(cfg, device="meta").params))
    print(f"arch={cfg.name} params={n:,}")
    if not args.occl_sync:
        raise NotImplementedError(
            "the default training path (TrainController + checkpoints) is "
            "not ported yet (ROADMAP.md, 'Modules to port', item 8); run "
            "with --occl-sync")
    return run_occl_dp(cfg, cell, args, device)


def run_occl_dp(cfg, cell, args, device=None, on_step=None) -> dict:
    """Simulated DP training with OCCL gradient sync (paper Sec. 5.3):
    per-rank backward, ``OcclGradSync.all_reduce``, per-rank AdamW.
    ``on_step(step, per_rank_grads, averaged_grads, sync)``, if given, runs
    after each step's sync (a caller's check of the average).  Returns
    ``{"states", "sync", "pipes", "log"}`` so a caller can go on from where
    the loop stopped."""
    from ..data.pipeline import SyntheticPipeline
    from ..train.occl_sync import OcclGradSync
    from ..train.state import init_state
    from ..train.step import make_apply_step, make_grads_step

    dp = args.dp
    assert cell.global_batch % dp == 0
    states = [init_state(cfg, device=device)      # identical seeds
              for _ in range(dp)]
    pipes = [SyntheticPipeline(cfg, cell, shard_id=r, n_shards=dp)
             for r in range(dp)]
    grads_fn = make_grads_step(cfg)
    apply_fn = make_apply_step(cfg)
    sync = OcclGradSync(init_state(cfg, device="meta").params, dp,
                        bucket_elems=args.bucket_elems,
                        slice_elems=args.slice_elems,
                        burst_slices=args.burst_slices, device=device)
    log = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        per_rank, losses = [], []
        for r in range(dp):
            loss, g = grads_fn(states[r], next(pipes[r]))
            per_rank.append(g)
            losses.append(float(loss))
        s0 = int(sync.stats()["supersteps"].max())
        synced = sync.all_reduce(per_rank)
        states = [apply_fn(states[r], synced[r]) for r in range(dp)]
        if states[0].step.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if on_step is not None:
            on_step(step, per_rank, synced, sync)
        del per_rank, synced
        steps = int(sync.stats()["supersteps"].max()) - s0
        log.append({"step": step, "loss": float(np.mean(losses)),
                    "wall_s": wall, "supersteps": steps,
                    "launches": sync.occl.launches})
        print(f"step {step:3d} loss {np.mean(losses):.4f} "
              f"{wall * 1e3:9.1f} ms supersteps {steps} "
              f"(occl launches={sync.occl.launches})")
    st = sync.stats()
    print("occl grad-sync: supersteps", int(st["supersteps"].max()),
          "preempts", int(st["preempts"].sum()))
    return {"states": states, "sync": sync, "pipes": pipes, "log": log}


if __name__ == "__main__":
    main()
