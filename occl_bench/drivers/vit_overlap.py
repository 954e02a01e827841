"""``train.step.make_overlap_grads_step`` (buckets submitted from inside
the backward pass, ``ticks_per_boundary`` ticks at each boundary, drained
in-step with ``drain_iters``) then ``make_apply_step``."""
from __future__ import annotations

from ..harness.port import nest, port_config
from ..harness.window import Ctx, Outcome


def run(ctx: Ctx) -> Outcome:
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.train.step import (make_apply_step,
                                        make_overlap_grads_step)

    cfg, wl, dev, fam, ref = (ctx.cfg, ctx.wl, ctx.device, ctx.family,
                              ctx.reference)
    dep = cfg["deployment"]
    R = dep["dp_ranks"]
    port_cfg = port_config(cfg)
    fam.check_port_tree(cfg, port_cfg, ref)
    fam.check_optimizer(cfg)
    params = fam.params(cfg, ctx.seed, dev, ref)
    feed = fam.Feed(cfg, ctx.seed, dev)
    trail = fam.Trail(R)
    sync_obj = OcclGradSync(nest(params), R,
                            bucket_elems=dep["bucket_elems"],
                            slice_elems=dep["slice_elems"],
                            burst_slices=dep["burst_slices"], device=dev)
    step_fn = make_overlap_grads_step(
        port_cfg, sync_obj, ticks_per_boundary=wl["ticks_per_boundary"],
        drain_iters=wl["drain_iters"])
    apply_fn = make_apply_step(port_cfg)
    states = [fam.state(params) for _ in range(R)]
    held = {"sync": sync_obj, "step": step_fn}
    t = 0
    while True:
        batches = [feed.batch_for(t, r) for r in range(R)]
        st, losses, grads = step_fn(sync_obj.occl.state,
                                    [s.params for s in states], batches)
        sync_obj.occl.adopt_state(st)
        states = [apply_fn(states[r], grads[r]) for r in range(R)]
        del st, grads
        for r in range(R):
            trail.lost(t, r, losses[r])
            trail.entered(t + 1, r, states[r])
        t += 1
        if t == fam.WARM_STEPS:
            ctx.window.start(sync_obj.occl,
                             fam.CHECKED_STEPS - fam.WARM_STEPS)
        elif t > fam.WARM_STEPS and ctx.window.step_done():
            break
    del sync_obj, step_fn, states
    return Outcome(fam.checker(cfg, params, feed, trail, ref), held.clear)
