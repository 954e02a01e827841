"""``train.occl_moe.OcclMoE.forward`` (``mode`` ``barrier``: payloads
staged through the host, one flush, ``drive()``, bulk reads per exchange)
or ``forward_overlapped`` (``overlap``: the all-to-alls ticked in-step), on
new tokens every step, after ``WARMUP_FORWARDS`` forwards on tokens of
their own.  The tick graphs the path replays (``warm_ticks``) are captured
in set-up."""
from __future__ import annotations

import torch

from ..harness.port import port_config
from ..harness.window import Ctx, Outcome

WARMUP_FORWARDS = 1   # forwards in set-up, on tokens of their own


def run(ctx: Ctx) -> Outcome:
    from repro_torch.train.occl_moe import OcclMoE

    cfg, wl, dev, fam, ref = (ctx.cfg, ctx.wl, ctx.device, ctx.family,
                              ctx.reference)
    dep = cfg["deployment"]
    port_cfg = port_config(cfg)
    cap = fam.capacity(cfg, ref)
    layer = OcclMoE(port_cfg, dep["ep_ranks"], dep["tokens_per_rank"],
                    slice_elems=dep["slice_elems"],
                    n_streams=dep["n_streams"],
                    overlap_ticks=dep["overlap_ticks"], device=dev)
    if layer.cap != cap or port_cfg.capacity_factor != cfg["capacity_factor"]:
        raise RuntimeError(f"the port's capacity {layer.cap} is not the "
                           f"configuration's {cap}")
    params = fam.params(cfg, ctx.seed, dev, ref)
    # Capture the tick graphs the path replays, from a state marked not
    # live: the warm-up bodies change nothing.
    layer.occl.device_api().step_prologue(layer.occl.state,
                                          ticks=tuple(wl["warm_ticks"]))
    fn = {"overlap": layer.forward_overlapped,
          "barrier": layer.forward}[wl["mode"]]
    # Warm-up forwards on tokens of their own: the first call of a layer
    # pays for allocations and the host's first touch of its buffers.
    for i in range(WARMUP_FORWARDS):
        fn(params, fam.tokens(cfg, ctx.seed, f"warm{i}", dev))
    outs = []
    ctx.window.start(layer.occl)
    step = 0
    while True:
        ys = fn(params, fam.tokens(cfg, ctx.seed, step, dev))
        outs.append(torch.stack(ys))
        del ys
        step += 1
        if ctx.window.step_done():
            break
    held = {"layer": layer}
    del layer, fn

    def check():
        return fam.out_gap(cfg, params, enumerate(outs), ctx.seed, dev, ref)

    return Outcome(check, held.clear)
