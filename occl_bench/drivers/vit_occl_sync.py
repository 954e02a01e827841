"""``repro_torch.launch.train.run_occl_dp`` (the ``--occl-sync`` command's
loop), driven through its ``on_step`` hook: per step the host packs each
bucket, one staged flush, ``drive()``, bulk reads, AdamW.

The loop draws its own state and data, so the driver swaps in, for the
duration of the call, an ``init_state`` that returns the seed's weights and
a pipeline that deals the seed's batches, and wraps ``make_grads_step`` and
``make_apply_step`` to keep each rank's loss and its state after the steps
the reference checks.  The window closes by raising out of the hook.
"""
from __future__ import annotations

import argparse

from ..harness.port import port_config, swapped
from ..harness.window import Ctx, Outcome


def run(ctx: Ctx) -> Outcome:
    import repro_torch.data.pipeline as pipe_mod
    import repro_torch.train.state as state_mod
    import repro_torch.train.step as step_mod
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.train import run_occl_dp

    cfg, dev, fam, ref = ctx.cfg, ctx.device, ctx.family, ctx.reference
    dep = cfg["deployment"]
    R = dep["dp_ranks"]
    port_cfg = port_config(cfg)
    fam.check_port_tree(cfg, port_cfg, ref)
    fam.check_optimizer(cfg)
    params = fam.params(cfg, ctx.seed, dev, ref)
    feed = fam.Feed(cfg, ctx.seed, dev)
    trail = fam.Trail(R)
    real_init, real_grads, real_apply = (state_mod.init_state,
                                         step_mod.make_grads_step,
                                         step_mod.make_apply_step)

    def init_state(c, seed=0, device=None):
        if str(device) == "meta":
            return real_init(c, seed, device)
        return fam.state(params)

    class Pipe:
        """The seed's batches, dealt as ``SyntheticPipeline`` would."""

        def __init__(self, c, cell, *, shard_id=0, n_shards=1, **_):
            self.rank, self.step = shard_id, 0

        def __next__(self):
            b = feed.batch_for(self.step, self.rank)
            self.step += 1
            return b

        def start(self):
            return self

        def stop(self):
            pass

    calls = {"grads": 0, "apply": 0}

    def make_grads_step(c):
        fn = real_grads(c)

        def grads(state, batch):
            loss, g = fn(state, batch)
            step, rank = divmod(calls["grads"], R)
            calls["grads"] += 1
            trail.lost(step, rank, loss)
            return loss, g
        return grads

    def make_apply_step(c, *opt):
        fn = real_apply(c, *opt)

        def apply(state, grads):
            new = fn(state, grads)
            step, rank = divmod(calls["apply"], R)
            calls["apply"] += 1
            trail.entered(step + 1, rank, new)
            return new
        return apply

    class Closed(Exception):
        pass

    held = {}

    def on_step(step, per_rank, synced, sync_obj):
        held["sync"] = sync_obj
        if step == fam.WARM_STEPS - 1:
            ctx.window.start(sync_obj.occl,
                             fam.CHECKED_STEPS - fam.WARM_STEPS)
        elif step >= fam.WARM_STEPS and ctx.window.step_done():
            raise Closed

    args = argparse.Namespace(
        dp=R, steps=1 << 30, bucket_elems=dep["bucket_elems"],
        slice_elems=dep["slice_elems"], burst_slices=dep["burst_slices"])
    cell = ShapeCell("bench", 0, dep["global_batch"], "train")
    with swapped(state_mod, "init_state", init_state), \
            swapped(pipe_mod, "SyntheticPipeline", Pipe), \
            swapped(step_mod, "make_grads_step", make_grads_step), \
            swapped(step_mod, "make_apply_step", make_apply_step):
        try:
            run_occl_dp(port_cfg, cell, args, dev, on_step=on_step)
        except Closed:
            pass
    return Outcome(fam.checker(cfg, params, feed, trail, ref), held.clear)
