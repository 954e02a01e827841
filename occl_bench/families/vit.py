"""The ViT classifier trained data-parallel: its weights and batches drawn
from the seed, its step's FLOPs, the reference's data-parallel steps, the
stand-ins (the control and the faults a training cell can have) and its
tiny CPU configuration.

Training drivers run ``WARM_STEPS`` steps in set-up and open the window
after them; the reference follows the first ``CHECKED_STEPS`` steps, the
window's first ones among them, so the window holds at least the rest of
them.  ``ref`` is the configuration's reference module
(``reference/<reference>.py``): ``param_shapes`` and ``loss_and_grads``.
"""
from __future__ import annotations

import torch

from ..harness import compare
from ..harness.feed import generator
from ..harness.port import flatten, nest
from ..reference import adamw as ref_adamw
from ..reference import numerics

WARM_STEPS = 1        # training steps in set-up: the first pays the captures
CHECKED_STEPS = 3     # training steps the reference follows
KINDS = ("control", "unchanged", "half_batch", "no_exchange",
         "answer_altered")


# ---------------------------------------------------------------------------
# weights and batches
# ---------------------------------------------------------------------------

def params(cfg: dict, seed: int, device, ref) -> dict:
    """Flat ViT parameters: normals of std ``initializer_range``, LayerNorm
    weights about 1, every leaf random (so every leaf has a gradient)."""
    shapes = ref.param_shapes(cfg)
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, "vit"),
                       device=device) * cfg["initializer_range"]
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = flat[off:off + n].view(shape).clone()
        if name.endswith("norm_w"):
            leaf += 1.0
        out[name] = leaf
        off += n
    return out


class Feed:
    """One global batch per step (normal patches, uniform labels), dealt
    to the ranks in contiguous shards."""

    def __init__(self, cfg: dict, seed: int, device):
        dep = cfg["deployment"]
        self.cfg, self.seed, self.device = cfg, seed, device
        self.ranks, self.batch = dep["dp_ranks"], dep["global_batch"]
        self._step, self._global = None, None

    def global_batch(self, step: int) -> dict:
        if self._step != step:
            g = generator(self.device, self.seed, "batch", step)
            c = self.cfg
            patches = torch.randn(
                (self.batch, c["num_patches"], c["hidden_size"]),
                generator=g, device=self.device)
            labels = torch.randint(0, c["num_labels"], (self.batch,),
                                   generator=g, device=self.device,
                                   dtype=torch.int32)
            self._step, self._global = step, (patches, labels)
        return self._global

    def batch_for(self, step: int, rank: int) -> dict:
        patches, labels = self.global_batch(step)
        n = self.batch // self.ranks
        sl = slice(rank * n, (rank + 1) * n)
        return {"patches": patches[sl], "labels": labels[sl]}


# ---------------------------------------------------------------------------
# FLOPs (a product of [m, k] by [k, n] counts 2*m*k*n; a training step three
# times its forward products; norms, softmax, element-wise work left out)
# ---------------------------------------------------------------------------

def layer_forward(tokens: int, d_model: int, d_ff: int) -> int:
    """One encoder layer on one sample: q, k, v and output projections,
    the score and value products over all heads, the two MLP products."""
    T, D, F = tokens, d_model, d_ff
    proj = 2 * T * D * (3 * D) + 2 * T * D * D
    attn = 2 * T * T * D + 2 * T * T * D
    mlp = 2 * T * D * F + 2 * T * F * D
    return proj + attn + mlp


def forward(cfg: dict) -> int:
    """One sample through the patch projection, the layers and the class
    head (over the published classes, not the padded ones)."""
    T, D = cfg["num_patches"], cfg["hidden_size"]
    patch = 2 * T * D * D
    layers = cfg["num_hidden_layers"] * layer_forward(
        T, D, cfg["intermediate_size"])
    head = 2 * D * cfg["num_labels"]
    return patch + layers + head


def step_flops(cfg: dict) -> int:
    """Forward and backward over the global batch of a data-parallel step."""
    return 3 * cfg["deployment"]["global_batch"] * forward(cfg)


# ---------------------------------------------------------------------------
# the program's trees and the steps the reference checks
# ---------------------------------------------------------------------------

class Trail:
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


def state(params: dict):
    """The program's train state holding ``params``, zero moments."""
    from repro_torch.train.state import TrainState

    p = nest({k: v.clone() for k, v in params.items()})
    z = lambda: nest({k: torch.zeros_like(v) for k, v in params.items()})
    return TrainState(p, z(), z(), torch.zeros((), dtype=torch.int32,
                                               device=next(iter(
                                                   params.values())).device))


def check_port_tree(cfg: dict, port_cfg, ref) -> None:
    """The program's parameter tree is the one the reference computes."""
    from repro_torch.train.state import init_state

    got = {k: tuple(v.shape) for k, v in
           flatten(init_state(port_cfg, device="meta").params).items()}
    want = {k: tuple(s) for k, s in ref.param_shapes(cfg).items()}
    if got != want:
        raise RuntimeError(f"the port's ViT tree differs from the "
                           f"configuration's: {got} != {want}")


def check_optimizer(cfg: dict) -> None:
    from repro_torch.optim.adamw import AdamWConfig

    if AdamWConfig()._asdict() != cfg["optimizer"]:
        raise RuntimeError(f"the port's AdamW defaults {AdamWConfig()} "
                           f"differ from the configuration's optimizer")


def reference_steps(cfg: dict, params: dict, feed, steps: int, ref,
                    quant=numerics.exact, fault: str | None = None) -> dict:
    """The reference's first ``steps`` data-parallel steps: per-rank
    losses, the averaged first gradient, the first moment after step 0
    and the parameters after ``steps``.  ``fault`` plants one of the
    faults a training cell can have, in the reference put in the
    program's place (``standin``): ``half_batch`` (each rank's loss over
    the first half of its rows), ``no_exchange`` (a rank steps on its
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
                b = feed.batch_for(t, r)
                x, y = b["patches"], b["labels"]
                if fault == "half_batch":
                    x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
                loss, g = ref.loss_and_grads(cfg, p, x, y, quant)
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


def checker(cfg, params, feed, trail, ref):
    """The outcome's ``check``: the reference over the trail's steps."""
    def check():
        want = reference_steps(cfg, params, feed, trail.n, ref)
        return compare.training(trail.program(), want, params)
    return check


# ---------------------------------------------------------------------------
# stand-ins and the tiny CPU configuration
# ---------------------------------------------------------------------------

def standin(cfg: dict, wl: dict, seed: int, device, kind: str, ref) -> dict:
    """The readings of the control (float8 operands) or of one fault, in
    the program's place, over the checked steps."""
    p = params(cfg, seed, device, ref)
    feed = Feed(cfg, seed, device)
    want = reference_steps(cfg, p, feed, CHECKED_STEPS, ref)
    if kind == "control":
        alt = reference_steps(cfg, p, feed, CHECKED_STEPS, ref,
                              quant=numerics.fp8)
    else:
        alt = reference_steps(cfg, p, feed, CHECKED_STEPS, ref, fault=kind)
    R = cfg["deployment"]["dp_ranks"]
    prog = {"losses": alt["losses"], "m1": [alt["m1"]] * R,
            "pn": [alt["pn"]] * R}
    return compare.training(prog, want, p)


def tiny(cfg: dict, wl: dict) -> tuple[dict, dict]:
    """The configuration and workload cut so that a cell's whole run takes
    seconds on the CPU (float32 products, so a sound run reads rounding
    alone)."""
    cfg.update(hidden_size=64, num_attention_heads=2, head_dim=32,
               intermediate_size=128, num_patches=16, num_labels=10)
    cfg["port"]["overrides"].update(
        d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
        vocab=10, vis_tokens=16, compute_dtype="float32")
    cfg["deployment"].update(global_batch=8, bucket_elems=1 << 16,
                             slice_elems=2048, burst_slices=1)
    if "drain_iters" in wl:
        wl["drain_iters"] = 1024
    return cfg, wl
