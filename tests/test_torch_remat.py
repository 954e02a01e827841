"""``cfg.remat`` on the port: ``"none"``, ``"full"`` and ``"dots"`` (the
reference's ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
products without batch dimensions are saved, everything else is
recomputed in the backward pass).

A small dense config and a small ssm config, on the CPU: the gradients
are bitwise equal under the three policies (recomputation repeats the
same ops on the same inputs), and a dispatch mode counts the 2-D products
(``aten.mm``) and batched ones (``aten.bmm``) run in the backward pass:
``"dots"`` reruns no forward ``mm`` (its count is ``"none"``'s) but reruns
the batched ones; ``"full"`` reruns both.
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models import build_model
from repro_torch.train.state import init_state
from repro_torch.train.step import as_batch
from repro_torch.tree import tree_leaves, tree_unflatten

POLICIES = ("none", "full", "dots")
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


class CountProducts(TorchDispatchMode):
    """Counts the ``PRODUCTS`` dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.calls[func] += 1
        return func(*args, **(kwargs or {}))


def backward(cfg) -> tuple[list, collections.Counter]:
    """The gradients of one seeded batch's loss and the products the
    backward pass ran."""
    params = init_state(cfg, device="cpu").params
    batch = SyntheticPipeline(cfg, ShapeCell("t", 64, 2, "train")).batch_at(0)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = build_model(cfg).loss_fn(tree_unflatten(params, leaves),
                                    as_batch(batch, "cpu"))
    with CountProducts() as count:
        grads = torch.autograd.grad(loss, leaves)
    return list(grads), count.calls


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
def test_dots_saves_products_without_batch_dims(arch):
    base = get_config(arch).reduced()
    runs = {p: backward(dataclasses.replace(base, remat=p))
            for p in POLICIES}
    want, none = runs["none"]
    for p in ("full", "dots"):
        grads, _ = runs[p]
        assert all(torch.equal(a, b) for a, b in zip(grads, want)), p
    mm, bmm = PRODUCTS
    full, dots = runs["full"][1], runs["dots"][1]
    assert none[mm] > 0 and none[bmm] > 0, none
    assert dots[mm] == none[mm], (dots, none)
    assert full[mm] > none[mm], (full, none)
    assert dots[bmm] == full[bmm] > none[bmm], (dots, full, none)


def test_chip_smoke_remat_steps_at_reduced_size():
    """``chip_smoke.py`` phase 7i's remat comparison on the CPU at the
    reduced width: both policies train from the same state on the same
    batches to the same losses."""
    import importlib.util

    from torch_parity import ROOT

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.remat_steps("cpu", dict(cs.TRAIN_DEFAULT, reduced=True))
    assert res["dots"]["losses"] == res["full"]["losses"]
    assert len(res["full"]["step_ms"]) == cs.REMAT_STEPS
