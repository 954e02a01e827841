"""The port's model substrate against the reference, on reduced configs.

Parameters are carried across from the reference's init
(``repro_torch.models.convert``): the two RNGs differ.  Tolerances:

* ``compute_dtype="float32"``: loss and every gradient leaf at
  ``rtol=1e-5, atol=1e-6`` (the only differences are float32 summation
  orders inside matmuls and reductions);
* the configs' own ``bfloat16`` compute: loss within ``rtol=2e-4`` and each
  gradient leaf within 5e-2 of the reference in relative L2 norm (bf16
  matmul outputs round at 2^-8; a one-ulp difference in one activation
  moves the gradients of everything upstream of it);
* layers, attention and AdamW in float32 at ``rtol=1e-5`` (AdamW's new
  parameters at ``rtol=1e-6``);
* the moe block against the reference's at ``rtol=1e-5, atol=1e-9``
  (outputs are about 1e-4; the routing is the same, the products sum in
  another order), and against the dense oracle and between its two
  combines at the reference's own ``rtol=2e-4, atol=2e-5``.

Leaf order and shapes equal ``jax.tree_util.tree_leaves`` — at full size
for ViT-Base, Mamba2-2.7B, Zamba2-1.2B, PaliGemma-3B and SeamlessM4T too
(``jax.eval_shape`` against the meta device) — since they decide the
gradient buckets; every registered arch builds on the meta device with the
reference's leaf count.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.moe as JM
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
import repro_torch.models.moe as TM
from repro.configs import get_config as jget
from repro.configs.base import ShapeCell as JCell
from repro.data.pipeline import SyntheticPipeline as JPipe
from repro.models import train_specs as jspecs
from repro.models.transformer import mask_vocab_logits as jmask
from repro.optim import adamw as JO
from repro.train.state import init_state as jinit
from repro.train.step import make_grads_step as jgrads
from repro.train.step import make_train_step as jtrain
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.models import build_model, train_specs
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.transformer import mask_vocab_logits, padded_vocab
from repro_torch.optim import adamw as TO
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import make_grads_step, make_train_step
from repro_torch.tree import tree_leaves
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("vit-base", "qwen3-0.6b", "deepseek-moe-16b", "mamba2-2.7b",
         "zamba2-1.2b", "paligemma-3b", "seamless-m4t-large-v2")
FULL_PARAMS = {"vit-base": 86_535_936, "mamba2-2.7b": 3_126_248_960,
               "zamba2-1.2b": 1_188_848_256, "paligemma-3b": 3_039_897_600,
               "seamless-m4t-large-v2": 2_034_886_656}


def configs(arch, compute_dtype=None):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    if compute_dtype:
        jc = dataclasses.replace(jc, compute_dtype=compute_dtype)
        tc = dataclasses.replace(tc, compute_dtype=compute_dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def tree_paths(tree, prefix=""):
    """"a/b/c" key paths of a nested dict, in sorted-key leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def jnp_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# configs, specs, data
# ---------------------------------------------------------------------------

def test_configs_equal_reference():
    from repro.configs import _REGISTRY as jreg
    from repro_torch.configs import _REGISTRY as treg

    assert jreg == treg
    for arch in jreg:
        assert dataclasses.asdict(jget(arch)) == dataclasses.asdict(
            tget(arch))
        assert dataclasses.asdict(jget(arch).reduced()) == dataclasses.asdict(
            tget(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_and_pipeline_equal_reference(arch):
    jc, tc = configs(arch)
    cell = ShapeCell("t", 16, 8, "train")
    js = jspecs(jc, JCell("t", 16, 8, "train"))
    ts = train_specs(tc, cell)
    assert js.keys() == ts.keys()
    for k in js:
        assert tuple(js[k].shape) == ts[k].shape
        assert str(js[k].dtype) == str(ts[k].dtype).replace("torch.", "")
    for shard in range(2):
        jb = JPipe(jc, JCell("t", 16, 8, "train"), shard_id=shard,
                   n_shards=2).batch_at(3)
        tb = SyntheticPipeline(tc, cell, shard_id=shard,
                               n_shards=2).batch_at(3)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32) * 0.1
    b = rng.randn(16).astype(np.float32) * 0.1
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    close(TL.rms_norm(t(x), t(w)), JL.rms_norm(jnp.asarray(x), w))
    close(TL.layer_norm(t(x), t(w), t(b)), JL.layer_norm(jnp.asarray(x), w, b))
    pos = np.broadcast_to(np.arange(5), (2, 5))
    close(TL.rope(t(x), t(pos.copy()), 1e4),
          JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    h = rng.randn(4, 16).astype(np.float32)
    w1, w2, w3 = (rng.randn(16, 32).astype(np.float32) * 0.2,
                  rng.randn(16, 32).astype(np.float32) * 0.2,
                  rng.randn(32, 16).astype(np.float32) * 0.2)
    b1, b2 = rng.randn(32).astype(np.float32), rng.randn(16).astype(
        np.float32)
    close(TL.swiglu(t(h), t(w1), t(w2), t(w3)), JL.swiglu(h, w1, w2, w3))
    close(TL.gelu_mlp(t(h), t(w1), t(b1), t(w3), t(b2)),
          JL.gelu_mlp(h, w1, b1, w3, b2))
    logits = rng.randn(3, 7, 300).astype(np.float32)
    tgt = rng.randint(-1, 300, (3, 7)).astype(np.int32)
    close(TL.cross_entropy(t(logits), t(tgt)), JL.cross_entropy(logits, tgt))
    assert padded_vocab(1000) == 1024 and padded_vocab(256) == 256
    close(mask_vocab_logits(t(logits), 290), jmask(jnp.asarray(logits), 290))


@pytest.mark.parametrize("mode,window,prefix", [
    ("causal", 0, 0), ("bidir", 0, 0), ("prefix", 0, 3), ("causal", 4, 0)])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_matches_reference(monkeypatch, mode, window, prefix,
                                     kv_heads):
    rng = np.random.RandomState(kv_heads * 10 + window)
    q = rng.randn(2, 16, 4, 8).astype(np.float32)
    k = rng.randn(2, 16, kv_heads, 8).astype(np.float32)
    v = rng.randn(2, 16, kv_heads, 8).astype(np.float32)
    kw = dict(mode=mode, window=window, prefix_len=prefix)
    want = JA.attention(q, k, v, **kw)
    got = TA.attention(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setenv("REPRO_KV_BLOCK", "4")
    want = JA.blockwise_attention(q, k, v, **kw)
    got = TA.blockwise_attention(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setenv("REPRO_BLOCKWISE_THRESHOLD", "8")
    got = TA.full_or_blockwise(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the moe block (models/moe.py)
# ---------------------------------------------------------------------------

def moe_setup(capacity_factor, seed):
    jc, tc = configs("deepseek-moe-16b")
    jc = dataclasses.replace(jc, capacity_factor=capacity_factor)
    tc = dataclasses.replace(tc, capacity_factor=capacity_factor)
    jp = JM.init_moe_block(jax.random.PRNGKey(0), "t", jc, jnp.float32)
    tp = params_from_numpy(jnp_tree(jp), "cpu")
    x = (np.random.RandomState(seed).randn(2, 8, jc.d_model) * 0.5).astype(
        np.float32)
    return jc, jp, tc, tp, x


@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_forward_matches_reference(monkeypatch, combine,
                                       capacity_factor):
    """Both combines, without drops (cf 8) and with them (cf 1.25)."""
    monkeypatch.setenv("REPRO_MOE_COMBINE", combine)
    jc, jp, tc, tp, x = moe_setup(capacity_factor, 2)
    jy, jaux = JM.moe_forward(jc, jp, jnp.asarray(x))
    ty, taux = TM.moe_forward(tc, tp, t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-6)


def test_moe_dispatch_matches_dense_oracle():
    jc, jp, tc, tp, x = moe_setup(8.0, 2)      # no drops
    y, aux = TM.moe_forward(tc, tp, t(x))
    y_ref = TM.moe_forward_dense_ref(tc, tp, t(x))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(
        y_ref.numpy(), np.asarray(JM.moe_forward_dense_ref(
            jc, jp, jnp.asarray(x))), rtol=1e-5, atol=1e-9)
    assert np.isfinite(float(aux))


def test_moe_combine_scatter_matches_gather(monkeypatch):
    _, _, tc, tp, x = moe_setup(8.0, 4)
    y_g, _ = TM.moe_forward(tc, tp, t(x))
    monkeypatch.setenv("REPRO_MOE_COMBINE", "scatter")
    y_s, _ = TM.moe_forward(tc, tp, t(x))
    np.testing.assert_allclose(y_g.numpy(), y_s.numpy(), rtol=2e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the model: leaf order, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,reduced", [
    *((a, True) for a in ARCHS), *((a, False) for a in FULL_PARAMS)])
def test_leaf_order_and_shapes_equal_reference(arch, reduced):
    jc, tc = jget(arch), tget(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jp = jax.eval_shape(lambda: jinit(jc).params)
    tp = init_state(tc, device="meta").params
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tp)
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert [str(a.dtype) for a in jl] == [
        str(b.dtype).replace("torch.", "") for b in tl]
    jpaths = ["/".join(str(k.key) for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert jpaths == tree_paths(tp)
    if not reduced:
        assert sum(int(np.prod(b.shape)) for b in tl) == FULL_PARAMS[arch]


def grads_both(arch, compute_dtype, batch_size=4):
    jc, tc = configs(arch, compute_dtype)
    js = jinit(jc)
    batch = JPipe(jc, JCell("t", 16, batch_size, "train")).batch_at(1)
    jl, jg = jax.jit(jgrads(jc))(js, batch)
    ts = TrainState(params_from_numpy(jnp_tree(js.params), "cpu"), None,
                    None, torch.zeros((), dtype=torch.int32))
    tl, tg = make_grads_step(tc)(ts, batch)
    return (float(jl), jax.tree_util.tree_leaves(jg)), (float(tl),
                                                         tree_leaves(tg))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32(arch):
    (jl, jg), (tl, tg) = grads_both(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, b in zip(jg, tg):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bfloat16(arch):
    (jl, jg), (tl, tg) = grads_both(arch, None)
    assert tget(arch).compute_dtype == "bfloat16"
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    for a, b in zip(jg, tg):
        a = np.asarray(a, np.float32)
        err = np.linalg.norm(b.numpy() - a) / max(np.linalg.norm(a), 1e-30)
        assert err < 5e-2, err


def test_init_is_seeded_and_order_free():
    tc = tget("vit-base").reduced()
    a = build_model(tc).init(3, "cpu")
    b = build_model(tc).init(3, "cpu")
    c = build_model(tc).init(4, "cpu")
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["head"], c["head"])
    # per-layer draws are stacked: layer slices differ
    assert not torch.equal(a["layers"]["mlp"]["w1"][0],
                           a["layers"]["mlp"]["w1"][1])


def test_every_arch_inits_on_meta_with_reference_leaf_count():
    """Every registered arch, every family included, builds at full size
    on the meta device with the reference's number of leaves."""
    from repro.configs import _REGISTRY as jreg

    for arch in jreg:
        jp = jax.eval_shape(lambda: jinit(jget(arch)).params)
        tp = build_model(tget(arch)).init(0, "meta")
        assert len(tree_leaves(tp)) == len(jax.tree_util.tree_leaves(jp)), \
            arch


# ---------------------------------------------------------------------------
# AdamW and the whole train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 57, 150, 20000])
def test_schedule_matches_reference(step):
    cfg = JO.AdamWConfig()
    want = JO.schedule(cfg, jnp.int32(step))
    got = TO.schedule(TO.AdamWConfig(), torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("step,scale", [(0, 1.0), (150, 30.0)])
def test_adamw_update_matches_reference(step, scale):
    rng = np.random.RandomState(step)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}
    mk = lambda s: jax.tree_util.tree_map(
        lambda sh: (rng.randn(*sh) * scale).astype(np.float32), s,
        is_leaf=lambda x: isinstance(x, tuple))
    p, g, m = mk(shapes), mk(shapes), mk(shapes)
    v = jax.tree_util.tree_map(np.abs, mk(shapes))
    jout = JO.adamw_update(JO.AdamWConfig(), p, g, m, v, jnp.int32(step))
    tt = lambda tree: params_from_numpy(tree, "cpu")
    tout = TO.adamw_update(TO.AdamWConfig(), tt(p), tt(g), tt(m), tt(v),
                           torch.tensor(step, dtype=torch.int32))
    for jo, to in zip(jout[:3], tout[:3]):
        for a, b in zip(jax.tree_util.tree_leaves(jo), tree_leaves(to)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One make_train_step step (float32 compute) from the reference's
    state, carried across, moments included."""
    jc, tc = configs(arch, "float32")
    js = jinit(jc)
    batch = JPipe(jc, JCell("t", 16, 4, "train")).batch_at(0)
    js1, jm = jax.jit(jtrain(jc))(js, batch)
    ts = train_state_from_numpy(*(jnp_tree(x) for x in js), device="cpu")
    ts1, tm = make_train_step(tc)(ts, batch)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-5)
    assert int(ts1.step) == int(js1.step) == 1
    for jx, tx in zip(js1[:3], ts1[:3]):
        for a, b in zip(jax.tree_util.tree_leaves(jx),
                        tree_leaves(tx)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
