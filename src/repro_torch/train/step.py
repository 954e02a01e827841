"""Training steps: the functions that make each step.

PyTorch port of ``repro.train.step``: train, grads, apply, the
overlapped grads step, and the prefill and decode steps (their only
caller is the dry run, ``launch/dryrun.py``).  A step takes a batch as a
dict of numpy arrays or tensors and moves it to the parameters' device.

The train step CONSUMES its input state: AdamW writes the new parameters
and moments into the input's tensors, one leaf at a time (the values are
the reference's), so a full-width state is never held twice.  This is
what donating the state to the reference's jitted step would do; callers
that must keep a state copy it first, as ``AsyncCheckpointer`` does.

Overlapped grad sync (the tick contract inside a training step)
----------------------------------------------------------------
``make_overlap_grads_step`` moves grad sync INSIDE the backward pass: an
identity ``autograd.Function`` boundary wraps each (bucket, rank)'s
parameter leaves, and its backward runs when that bucket's gradients
materialize — it submits the bucket (core/device_api.py) and advances the
daemon by a bounded OVERLAP ``tick(state, k)``, so all-reduce supersteps
run inside the backward pass instead of trailing it as a barrier.

* A TOKEN (a scalar that requires grad) threads the boundaries in
  bucket-major order, like the reference's state cotangent: each
  boundary's backward runs only after the next one in the chain handed it
  the token's gradient, which pins the backward submission order — bucket
  0 on every rank (ranks R-1 .. 0, the reference's transposition order),
  then bucket 1, and so on.  The daemon state itself stays in the step's
  own object, not in gradient math (autograd may sum cotangents, which
  would corrupt bit-viewed integers).
* The boundaries run on the autograd engine's thread, so every tick there
  only REPLAYS CUDA graphs: the step prologue captures the tick graphs
  first (``DeviceApi.step_prologue(st, ticks=...)``), ``submit`` writes the
  heap in place, and the relaunch check is a device-side select.
* After the backward pass the step drains with BARRIER ticks (the only
  exposed communication when overlap worked) and reads the reduced
  buckets; ``stats()`` splits the superstep clock into overlap and
  barrier supersteps.  The sim backend runs the hidden ticks on the same
  stream as the backward pass, so on one card they do not overlap in wall
  time; the split is the structural count the reference records.
* The caller hands the final state back with ``runtime.adopt_state``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.daemon import TICK_CHUNK, _drained
from ..core.errors import StepTimeout
from ..models import build_model
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import tree_leaves, tree_unflatten
from .state import TrainState


def as_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _grads(model, params, batch):
    """(loss, grads) of ``model.loss_fn`` at ``params``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    loss = model.loss_fn(p, as_batch(batch, leaves[0].device))
    gs = torch.autograd.grad(loss, leaves)
    return loss.detach().float(), tree_unflatten(params, list(gs))


def make_train_step(cfg: ArchConfig,
                    opt: AdamWConfig = AdamWConfig()) -> Callable:
    model = build_model(cfg)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = _grads(model, state.params, batch)
        new_p, new_m, new_v, gnorm = adamw_update(
            opt, state.params, grads, state.m, state.v, state.step,
            inplace=True)
        metrics = {"loss": loss, "grad_norm": gnorm}
        return TrainState(new_p, new_m, new_v, state.step + 1), metrics

    return train_step


def make_grads_step(cfg: ArchConfig) -> Callable:
    """Backward only — used by the OCCL grad-sync integration, which
    synchronizes gradient buckets itself (train/occl_sync.py) and then
    applies make_apply_step."""
    model = build_model(cfg)

    def grads_step(state: TrainState, batch):
        return _grads(model, state.params, batch)

    return grads_step


class _Boundary(torch.autograd.Function):
    """Identity on (token, *bucket leaves); its backward hands the leaves'
    gradients to ``hook`` (submit + overlap tick) and passes the token's
    gradient on.  The leaves get no gradient of their own."""

    @staticmethod
    def forward(ctx, hook, token, *leaves):
        ctx.hook = hook
        return (token.view_as(token),) + tuple(l.view_as(l) for l in leaves)

    @staticmethod
    def backward(ctx, dtoken, *dleaves):
        ctx.hook(dleaves)
        return (None, dtoken) + (None,) * len(dleaves)


def make_overlap_grads_step(cfg: ArchConfig, sync,
                            ticks_per_boundary: int = 4,
                            drain_iters: int = 1024) -> Callable:
    """Backward pass with IN-STEP bucketized grad sync (module docstring).

    ``sync`` is an :class:`~repro_torch.train.occl_sync.OcclGradSync`; the
    returned function

        ``step(st, per_rank_params, per_rank_batch)
            -> (st, losses[R], grads_list)``

    takes the runtime's DaemonState and returns the averaged grads
    (bit-comparable to ``sync.all_reduce``); the caller re-installs the
    final state with ``sync.occl.adopt_state(st)``.  ``ticks_per_boundary``
    is the overlap budget spent after each bucket submission;
    ``drain_iters`` bounds the final drain at that many ticks of
    ``TICK_CHUNK`` supersteps (the reference's 1024 by default), and the
    step raises :class:`~repro_torch.core.errors.StepTimeout` when work is
    still pending after it (where the reference would read partial
    sums)."""
    model = build_model(cfg)
    api = sync.device_api()
    R = sync.n_ranks
    buckets = sync.buckets

    def step(st, per_rank_params, per_rank_batch):
        st = api.step_prologue(st, ticks=(ticks_per_boundary, TICK_CHUNK))
        box = {"st": st}

        def hook(rank: int, bidx: int):
            cid = buckets[bidx].coll_id

            def submit_and_tick(dleaves):
                flat = torch.cat([d.reshape(-1).float() for d in dleaves])
                s = api.submit(box["st"], rank, cid, flat, prio=bidx)
                box["st"], _ = api.tick(s, ticks_per_boundary, barrier=False)

            return submit_and_tick

        dev = sync.device
        flats = [[p.detach() for p in tree_leaves(params)]
                 for params in per_rank_params]
        token = torch.zeros((), device=dev, requires_grad=True)
        # Wrapping bucket NB-1 .. 0 here makes the backward pass submit
        # bucket 0 first (see the module docstring).
        for bidx in reversed(range(len(buckets))):
            b = buckets[bidx]
            for r in range(R):
                out = _Boundary.apply(hook(r, bidx), token,
                                      *[flats[r][i] for i in b.leaf_ids])
                token = out[0]
                for i, leaf in zip(b.leaf_ids, out[1:]):
                    flats[r][i] = leaf
        losses = [model.loss_fn(tree_unflatten(per_rank_params[r], flats[r]),
                                as_batch(per_rank_batch[r], dev))
                  for r in range(R)]
        total = sum(l.float() for l in losses)
        torch.autograd.backward([total, token],
                                [torch.ones_like(total),
                                 torch.zeros_like(token)])
        st = api.drain(box["st"], max_iters=drain_iters)
        if not bool(_drained(st).all()):
            raise StepTimeout(
                f"overlap grads step: collectives still pending after "
                f"{drain_iters} drain ticks of {TICK_CHUNK} supersteps; "
                "raise drain_iters")
        grads = [sync.unflatten([api.read(st, r, b.coll_id).float() / R
                                 for b in buckets]) for r in range(R)]
        return st, torch.stack([l.detach() for l in losses]), grads

    return step


def make_apply_step(cfg: ArchConfig,
                    opt: AdamWConfig = AdamWConfig()) -> Callable:
    def apply_step(state: TrainState, grads) -> TrainState:
        new_p, new_m, new_v, _ = adamw_update(
            opt, state.params, grads, state.m, state.v, state.step)
        return TrainState(new_p, new_m, new_v, state.step + 1)

    return apply_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    model = build_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig) -> Callable:
    model = build_model(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step
