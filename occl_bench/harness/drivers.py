"""The general generator: one driver per program path, reading a cell's
traffic parameters (``workloads/<cell>.json``) and its configuration.

Each driver builds the program's objects from the configuration, hands
them the weights and inputs drawn from the seed (``feed.py``), runs the
set-up the traffic names, opens the window (``Window.start``), runs whole
steps until the window closes, and returns an :class:`Outcome` whose
``check()`` works the reference out again once the program is freed.

* ``vit_occl_sync``: ``repro_torch.launch.train.run_occl_dp`` (the
  ``--occl-sync`` command's loop), driven through its ``on_step`` hook.
  The loop draws its own state and data, so the driver swaps in, for the
  duration of the call, an ``init_state`` that returns the seed's weights
  and a pipeline that deals the seed's batches, and wraps
  ``make_grads_step`` and ``make_apply_step`` to keep each rank's loss and
  its state after the steps the reference checks.  The window closes by
  raising out of the hook.
* ``vit_overlap``: ``train.step.make_overlap_grads_step`` (buckets
  submitted from inside the backward pass) then ``make_apply_step``.
* ``moe``: ``train.occl_moe.OcclMoE.forward`` (``mode`` ``barrier``) or
  ``forward_overlapped`` (``overlap``), on new tokens every step, after
  ``WARMUP_FORWARDS`` forwards on tokens of their own.

A cell names its driver in ``DRIVERS``.  Training drivers run
``WARM_STEPS`` steps in set-up and open the window after them; the
reference follows the first ``CHECKED_STEPS`` steps, the window's first
ones among them, so the window holds at least the rest of them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import time

import torch

from ..reference import adamw as ref_adamw
from ..reference import moe as ref_moe
from ..reference import numerics
from ..reference import vit as ref_vit
from . import compare, feed
from .spans import sync

WARM_STEPS = 1        # training steps in set-up: the first pays the captures
CHECKED_STEPS = 3     # training steps the reference follows
WARMUP_FORWARDS = 1   # MoE forwards in set-up, on tokens of their own


def port_config(cfg: dict):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(cfg["port"]["arch"]),
                               **cfg["port"]["overrides"])


def nest(flat: dict) -> dict:
    """Flat ``a/b/c`` keys -> nested dicts (the program's parameter trees)."""
    out: dict = {}
    for path, v in flat.items():
        *outer, last = path.split("/")
        d = out
        for k in outer:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@contextlib.contextmanager
def swapped(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Window:
    """The measured window: opened after set-up, closed by the first whole
    step that ends ``seconds`` or more after it opened and is at least its
    ``min_steps``-th.  A traced run's spans cover the window; its profiled
    slice lies in one more step after the window (``profiling``), so the
    profiler's cost stays out of every timed reading."""

    def __init__(self, seconds, device, tracer=None):
        self.seconds, self.device, self.tracer = seconds, device, tracer
        self.steps = 0
        self.times: list = []
        self.t0 = self.t1 = None
        self.rt = None
        self.min_steps = 1
        self.profiling = False

    @staticmethod
    def counters(rt) -> dict:
        st = rt.stats()
        return {"supersteps": int(st["supersteps"].max()),
                "overlap_supersteps": int(st["overlap_supersteps"].max()),
                "preempts": int(st["preempts"].sum())}

    def start(self, rt, min_steps: int = 1) -> None:
        """Open the window; it closes no earlier than ``min_steps`` steps
        on."""
        sync(self.device)
        self.rt, self.min_steps = rt, min_steps
        self.c0 = self.counters(rt)
        if self.tracer is not None:
            self.tracer.start()
        self.t0 = self.last = time.perf_counter()

    def _close(self) -> None:
        if self.tracer is not None:
            self.tracer.stop()
        self.c1 = self.counters(self.rt)
        self.rt = None

    def step_done(self) -> bool:
        """True once the run should stop stepping."""
        sync(self.device)
        if self.profiling:
            self.tracer.slice.close()
            return True
        t = time.perf_counter()
        self.times.append(t - self.last)
        self.last = t
        self.steps += 1
        if t - self.t0 < self.seconds or self.steps < self.min_steps:
            return False
        self.t1 = t
        self._close()
        if self.tracer is None:
            return True
        self.tracer.arm()
        self.profiling = True
        return False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def delta(self, key: str) -> int:
        return self.c1[key] - self.c0[key]


@dataclasses.dataclass
class Ctx:
    cfg: dict
    wl: dict
    seed: int
    device: object
    window: Window


class Outcome:
    """What a driver hands back: ``release()`` (drop the program's
    objects) and ``check()`` (readings against the reference)."""

    def __init__(self, check, release):
        self._check, self._release = check, release

    def release(self) -> None:
        self._release()
        free()

    def check(self) -> dict:
        return self._check()


# ---------------------------------------------------------------------------
# ViT data-parallel training
# ---------------------------------------------------------------------------

class _Trail:
    """Each rank's loss of the first ``n`` steps and its state entering
    step 1 and step ``n``.  Inside the window it keeps references and
    copies of scalars only: nothing waits on the device."""

    def __init__(self, ranks: int, n: int = CHECKED_STEPS):
        self.ranks, self.n = ranks, n
        self.losses = [[None] * ranks for _ in range(n)]
        self.entering = {1: [None] * ranks, n: [None] * ranks}

    def lost(self, step: int, rank: int, loss) -> None:
        if step < self.n:
            self.losses[step][rank] = loss.detach().clone()

    def entered(self, step: int, rank: int, state) -> None:
        if step in self.entering:
            self.entering[step][rank] = state

    def program(self) -> dict:
        return {"losses": [[float(x) for x in s] for s in self.losses],
                "m1": [flatten(s.m) for s in self.entering[1]],
                "pn": [flatten(s.params) for s in self.entering[self.n]]}


def _state(params: dict):
    from repro_torch.train.state import TrainState

    p = nest({k: v.clone() for k, v in params.items()})
    z = lambda: nest({k: torch.zeros_like(v) for k, v in params.items()})
    return TrainState(p, z(), z(), torch.zeros((), dtype=torch.int32,
                                               device=next(iter(
                                                   params.values())).device))


def _check_port_tree(cfg: dict, port_cfg) -> None:
    """The program's parameter tree is the one the reference computes."""
    from repro_torch.train.state import init_state

    got = {k: tuple(v.shape) for k, v in
           flatten(init_state(port_cfg, device="meta").params).items()}
    want = {k: tuple(s) for k, s in ref_vit.param_shapes(cfg).items()}
    if got != want:
        raise RuntimeError(f"the port's ViT tree differs from the "
                           f"configuration's: {got} != {want}")


def _check_optimizer(cfg: dict) -> None:
    from repro_torch.optim.adamw import AdamWConfig

    if AdamWConfig()._asdict() != cfg["optimizer"]:
        raise RuntimeError(f"the port's AdamW defaults {AdamWConfig()} "
                           f"differ from the configuration's optimizer")


def vit_reference(cfg: dict, params: dict, vfeed, steps: int,
                  quant=numerics.exact, fault: str | None = None) -> dict:
    """The reference's first ``steps`` data-parallel steps: per-rank
    losses, the averaged first gradient, the first moment after step 0
    and the parameters after ``steps``.  ``fault`` plants one of the
    faults a training cell can have, in the reference put in the
    program's place (``standins.py``): ``half_batch`` (each rank's loss
    over the first half of its rows), ``no_exchange`` (a rank steps on its
    own gradient), ``answer_altered`` (the first leaf's average left as
    the sum) or ``unchanged`` (the step returns its state)."""
    R = cfg["deployment"]["dp_ranks"]
    opt = cfg["optimizer"]
    p = dict(params)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, m1, g0 = [], None, None
    with numerics.matmul_precision(tf32=False):
        for t in range(steps):
            per_rank, ls = [], []
            for r in range(R):
                b = vfeed.batch_for(t, r)
                x, y = b["patches"], b["labels"]
                if fault == "half_batch":
                    x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
                loss, g = ref_vit.loss_and_grads(cfg, p, x, y, quant)
                ls.append(float(loss))
                per_rank.append(g)
            avg = {k: sum(g[k] for g in per_rank) / R for k in p}
            if fault == "no_exchange":
                avg = per_rank[0]
            if fault == "answer_altered":
                avg = dict(avg)
                first = next(iter(avg))
                avg[first] = avg[first] * R
            losses.append(ls)
            if t == 0:
                g0 = avg
            if fault != "unchanged":
                p, m, v = ref_adamw.step(opt, p, avg, m, v, t)
            if t == 0:
                m1 = m
    return {"losses": losses, "m1": m1, "pn": p, "g0": g0}


def _vit_check(cfg, params, vfeed, trail):
    def check():
        ref = vit_reference(cfg, params, vfeed, trail.n)
        return compare.training(trail.program(), ref, params)
    return check


def vit_occl_sync(ctx: Ctx) -> Outcome:
    import repro_torch.data.pipeline as pipe_mod
    import repro_torch.train.state as state_mod
    import repro_torch.train.step as step_mod
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.train import run_occl_dp

    cfg, dev = ctx.cfg, ctx.device
    dep = cfg["deployment"]
    R = dep["dp_ranks"]
    port_cfg = port_config(cfg)
    _check_port_tree(cfg, port_cfg)
    _check_optimizer(cfg)
    params = feed.vit_params(cfg, ctx.seed, dev)
    vfeed = feed.VitFeed(cfg, ctx.seed, dev)
    trail = _Trail(R)
    real_init, real_grads, real_apply = (state_mod.init_state,
                                         step_mod.make_grads_step,
                                         step_mod.make_apply_step)

    def init_state(c, seed=0, device=None):
        if str(device) == "meta":
            return real_init(c, seed, device)
        return _state(params)

    class Pipe:
        """The seed's batches, dealt as ``SyntheticPipeline`` would."""

        def __init__(self, c, cell, *, shard_id=0, n_shards=1, **_):
            self.rank, self.step = shard_id, 0

        def __next__(self):
            b = vfeed.batch_for(self.step, self.rank)
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
        if step == WARM_STEPS - 1:
            ctx.window.start(sync_obj.occl, CHECKED_STEPS - WARM_STEPS)
        elif step >= WARM_STEPS and ctx.window.step_done():
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
    return Outcome(_vit_check(cfg, params, vfeed, trail), held.clear)


def vit_overlap(ctx: Ctx) -> Outcome:
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.train.step import (make_apply_step,
                                        make_overlap_grads_step)

    cfg, wl, dev = ctx.cfg, ctx.wl, ctx.device
    dep = cfg["deployment"]
    R = dep["dp_ranks"]
    port_cfg = port_config(cfg)
    _check_port_tree(cfg, port_cfg)
    _check_optimizer(cfg)
    params = feed.vit_params(cfg, ctx.seed, dev)
    vfeed = feed.VitFeed(cfg, ctx.seed, dev)
    trail = _Trail(R)
    sync_obj = OcclGradSync(nest(params), R,
                            bucket_elems=dep["bucket_elems"],
                            slice_elems=dep["slice_elems"],
                            burst_slices=dep["burst_slices"], device=dev)
    step_fn = make_overlap_grads_step(
        port_cfg, sync_obj, ticks_per_boundary=wl["ticks_per_boundary"],
        drain_iters=wl["drain_iters"])
    apply_fn = make_apply_step(port_cfg)
    states = [_state(params) for _ in range(R)]
    held = {"sync": sync_obj, "step": step_fn}
    t = 0
    while True:
        batches = [vfeed.batch_for(t, r) for r in range(R)]
        st, losses, grads = step_fn(sync_obj.occl.state,
                                    [s.params for s in states], batches)
        sync_obj.occl.adopt_state(st)
        states = [apply_fn(states[r], grads[r]) for r in range(R)]
        del st, grads
        for r in range(R):
            trail.lost(t, r, losses[r])
            trail.entered(t + 1, r, states[r])
        t += 1
        if t == WARM_STEPS:
            ctx.window.start(sync_obj.occl, CHECKED_STEPS - WARM_STEPS)
        elif t > WARM_STEPS and ctx.window.step_done():
            break
    del sync_obj, step_fn, states
    return Outcome(_vit_check(cfg, params, vfeed, trail), held.clear)


# ---------------------------------------------------------------------------
# DeepSeek-MoE expert-parallel layer
# ---------------------------------------------------------------------------

def moe_reference(cfg: dict, params: dict, xs: list, cap: int,
                  control: bool = False) -> list:
    """Every rank's reference output: float64 experts, or for the control
    TF32 operands in every product and float32 experts."""
    with numerics.matmul_precision(tf32=False):
        if control:
            return [ref_moe.layer(cfg, params, x, cap, torch.float32,
                                  numerics.tf32) for x in xs]
        return [ref_moe.layer(cfg, params, x, cap) for x in xs]


def moe(ctx: Ctx) -> Outcome:
    from repro_torch.train.occl_moe import OcclMoE

    cfg, wl, dev = ctx.cfg, ctx.wl, ctx.device
    dep = cfg["deployment"]
    port_cfg = port_config(cfg)
    T = dep["tokens_per_rank"]
    cap = ref_moe.capacity(T, cfg["num_experts_per_tok"],
                           cfg["n_routed_experts"], cfg["capacity_factor"])
    layer = OcclMoE(port_cfg, dep["ep_ranks"], T,
                    slice_elems=dep["slice_elems"],
                    n_streams=dep["n_streams"],
                    overlap_ticks=dep["overlap_ticks"], device=dev)
    if layer.cap != cap or port_cfg.capacity_factor != cfg["capacity_factor"]:
        raise RuntimeError(f"the port's capacity {layer.cap} is not the "
                           f"configuration's {cap}")
    params = feed.moe_params(cfg, ctx.seed, dev)
    # Capture the tick graphs the path replays, from a state marked not
    # live: the warm-up bodies change nothing.
    layer.occl.device_api().step_prologue(layer.occl.state,
                                          ticks=tuple(wl["warm_ticks"]))
    fn = {"overlap": layer.forward_overlapped,
          "barrier": layer.forward}[wl["mode"]]
    # Warm-up forwards on tokens of their own: the first call of a layer
    # pays for allocations and the host's first touch of its buffers.
    for i in range(WARMUP_FORWARDS):
        fn(params, feed.moe_tokens(cfg, ctx.seed, f"warm{i}", dev))
    outs = []
    ctx.window.start(layer.occl)
    step = 0
    while True:
        ys = fn(params, feed.moe_tokens(cfg, ctx.seed, step, dev))
        outs.append(torch.stack(ys))
        del ys
        step += 1
        if ctx.window.step_done():
            break
    held = {"layer": layer}
    del layer, fn

    def check():
        gap = 0.0
        for s, got in enumerate(outs):
            xs = feed.moe_tokens(cfg, ctx.seed, s, dev)
            want = moe_reference(cfg, params, xs, cap)
            gap = max([gap] + [compare.output_gap(g, w)
                               for g, w in zip(got, want)])
        return {"out_gap": gap}

    return Outcome(check, held.clear)


DRIVERS = {"vit_occl_sync": vit_occl_sync, "vit_overlap": vit_overlap,
           "moe": moe}


def cell_config(cfg: dict, wl: dict) -> dict:
    """The configuration as the cell runs it: the workload's
    ``deployment`` entries (its traffic: batch, tokens per rank) over the
    configuration's."""
    if not wl.get("deployment"):
        return cfg
    return dict(cfg, deployment=dict(cfg["deployment"], **wl["deployment"]))
