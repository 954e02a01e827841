"""The hybrid (Zamba2), vlm (PaliGemma) and encdec (SeamlessM4T) families
and the recursive-halving causal attention against the reference.

Configs are the archs' ``.reduced()`` ones (zamba2: 5 Mamba2 layers and the
shared block after every 2nd; paligemma: 8 image tokens, MQA; seamless: a
2-layer encoder over 24 frames).  Parameters are carried across from the
reference's init (``models/convert.py``); inputs are seeded numpy.
Tolerances:

* float32: ``rtol=1e-5, atol=1e-6`` (the packages differ only in float32
  summation orders);
* prefill then decode against a longer prefill: ``chip_smoke.py``'s bounds
  (``CACHE_CHECK_REL_L2``; the hybrid's ``HYBRID_CACHE_REL_L2``), the
  bounds phases 7k-7m hold at full width, on seeded non-zero ``patches`` /
  ``frames``.

The launchers on these archs: ``tests/test_torch_launch_families.py``.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.transformer as JT
import repro_torch.models.attention as TA
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro.configs import get_config as jget
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_leaves, tree_map
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("zamba2-1.2b", "paligemma-3b", "seamless-m4t-large-v2")
ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


def configs(arch, compute_dtype="float32"):
    jc = dataclasses.replace(jget(arch).reduced(), compute_dtype=compute_dtype)
    tc = dataclasses.replace(tget(arch).reduced(), compute_dtype=compute_dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def carried(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def randn(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layers and attention blocks
# ---------------------------------------------------------------------------

def test_geglu_matches_reference():
    h, wg, wu, wd = (randn((4, 16), 0), randn((16, 32), 1, 0.3),
                     randn((16, 32), 2, 0.3), randn((32, 16), 3, 0.3))
    close(TL.geglu(t(h), t(wg), t(wu), t(wd)), JL.geglu(h, wg, wu, wd))


@pytest.mark.parametrize("arch,mode,prefix,cross", [
    ("paligemma-3b", "prefix", 4, False),
    ("paligemma-3b", "causal", 0, False),
    ("seamless-m4t-large-v2", "bidir", 0, False),
    ("seamless-m4t-large-v2", "bidir", 0, True),
    ("zamba2-1.2b", "causal", 0, False)])
def test_attention_blocks_match_reference(arch, mode, prefix, cross):
    """``attn_train`` (cross-attention: a 7-position memory, no rope) and,
    for self-attention, ``attn_prefill``'s output and (k, v)."""
    jc, tc = configs(arch)
    jp = JT.init_attn(jax.random.PRNGKey(1), "a", jc, jnp.float32)
    tp = carried(jp)
    x = randn((2, 10, jc.d_model), 5)
    kw = dict(mode=mode, prefix_len=prefix)
    if cross:
        mem = randn((2, 7, jc.d_model), 6)
        want = JT.attn_train(jc, jp, x, kv_x=mem, rope_on=False, **kw)
        got = TT.attn_train(tc, tp, t(x), kv_x=t(mem), rope_on=False, **kw)
        close(got, want)
        return
    close(TT.attn_train(tc, tp, t(x), **kw), JT.attn_train(jc, jp, x, **kw))
    want, (jk, jv) = JT.attn_prefill(jc, jp, x, **kw)
    got, (tk, tv) = TT.attn_prefill(tc, tp, t(x), **kw)
    close(got, want)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_causal_rec_attention_matches_reference(monkeypatch, levels):
    """The recursive-halving path at S = 512 over KV blocks of 32: the
    reference's values, and the port's own blockwise causal attention."""
    monkeypatch.setenv("REPRO_KV_BLOCK", "32")
    q, k, v = (randn((1, 512, 4, 8), s) for s in (10, 11, 12))
    k, v = k[:, :, :2], v[:, :, :2]
    got = TA.causal_rec_attention(t(q), t(k), t(v), levels)
    close(got, JA.causal_rec_attention(q, k, v, levels))
    close(got, TA.blockwise_attention(t(q), t(k), t(v), mode="causal"))


@pytest.mark.parametrize("mode,window,prefix,skv", [
    ("causal", 0, 0, 32), ("causal", 4, 0, 32), ("bidir", 0, 0, 32),
    ("prefix", 0, 5, 32), ("bidir", 0, 0, 16)])
def test_full_or_blockwise_routes_as_reference(monkeypatch, mode, window,
                                               prefix, skv):
    """With ``REPRO_CAUSAL_REC`` set, a query over the threshold takes the
    recursive path only when causal, unwindowed and square; bidirectional,
    windowed, prefix and cross (Skv != Sq) inputs stream blockwise."""
    monkeypatch.setenv("REPRO_CAUSAL_REC", "2")
    monkeypatch.setenv("REPRO_BLOCKWISE_THRESHOLD", "16")
    monkeypatch.setenv("REPRO_KV_BLOCK", "8")
    q = randn((2, 32, 4, 8), 20)
    k, v = randn((2, skv, 2, 8), 21), randn((2, skv, 2, 8), 22)
    kw = dict(mode=mode, window=window, prefix_len=prefix)
    close(TA.full_or_blockwise(t(q), t(k), t(v), **kw),
          JA.full_or_blockwise(q, k, v, **kw))


# ---------------------------------------------------------------------------
# the models: carried weights, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_bit_for_bit(arch):
    """``params_from_numpy`` carries the new subtrees (``shared``,
    ``enc_layers`` / ``enc_norm`` / ``cross``, ``vis_proj``) as it does
    the others: the same paths, shapes and bits."""
    jc, tc = configs(arch)
    jp = JT.Model(jc).init(0)
    tp = carried(jp)
    paths = ["/".join(str(k.key) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    new = {"zamba2-1.2b": "shared/proj", "paligemma-3b": "vis_proj",
           "seamless-m4t-large-v2": "layers/cross/wk"}[arch]
    assert new in paths
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    mine = build_model(tc).init(0, "cpu")
    assert [tuple(a.shape) for a in tree_leaves(mine)] == [
        tuple(b.shape) for b in tree_leaves(tp)]


def check_inputs(cfg, n_decode, seed):
    """(tokens, patches / frames, pad_to) of a cache check: an ssm trunk
    prefills one chunk and decodes another."""
    prefill = cfg.ssm_chunk if cfg.ssm_state else 12
    n_decode = cfg.ssm_chunk if cfg.ssm_state else n_decode
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (2, prefill + n_decode)).astype(
        np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.randn(2, cfg.vis_tokens, cfg.d_model)
    if cfg.family == "encdec":
        extra["frames"] = rng.randn(2, cfg.enc_frames, cfg.d_model)
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    return toks, extra, prefill + n_decode + cfg.vis_tokens + 3, n_decode


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_check_on_nonzero_inputs(arch, compute_dtype):
    """``chip_smoke.cache_check`` (prefill, then decode steps against one
    longer prefill) on seeded patches / frames within phases 7k-7m's
    bounds; in float32 the decode chain's logits also equal the
    reference's longer prefill."""
    cs = smoke()
    jc, tc = configs(arch, compute_dtype)
    jm = JT.Model(jc)
    jp = jm.init(0)
    cdt = getattr(torch, compute_dtype)
    tp = tree_map(lambda a: a.to(cdt), carried(jp))
    toks, extra, pad_to, n_dec = check_inputs(tc, 1, 3)
    res = cs.cache_check(build_model(tc), tp, t(toks), pad_to, n_dec,
                         {k: t(v).to(cdt) for k, v in extra.items()})
    bounds = (cs.HYBRID_CACHE_REL_L2 if tc.family == "hybrid"
              else cs.LLAMA_BOUNDS)[compute_dtype]
    assert set(bounds) <= set(res), res
    for k, bound in bounds.items():
        assert res[k] <= bound, (k, res)
    if compute_dtype == "float32":
        tm = build_model(tc)
        S = toks.shape[1] - n_dec
        tx = {k: t(v) for k, v in extra.items()}
        _, cache = tm.prefill(tp, dict(tx, tokens=t(toks[:, :S])),
                              pad_to=pad_to)
        for i in range(S, toks.shape[1]):
            got, cache = tm.decode_step(tp, cache, t(toks[:, i]))
        want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks), **extra})
        close(got, np.asarray(want)[:, 0])


def test_vlm_short_cache_overwrites_the_last_slot():
    """The reference's behaviour, kept: a vlm prefill without room for the
    decode steps (no ``pad_to``) pads nothing, and every decode step writes
    the last slot (``min(pos, Smax - 1)``); logits and cache as the
    reference's."""
    jc, tc = configs("paligemma-3b")
    jm, tm = JT.Model(jc), build_model(tc)
    jp = jm.init(0)
    tp = carried(jp)
    toks = np.random.RandomState(8).randint(0, 256, (2, 6)).astype(np.int32)
    pat = randn((2, jc.vis_tokens, jc.d_model), 9)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "patches": jnp.asarray(pat)})
    tl, tcache = tm.prefill(tp, {"tokens": t(toks), "patches": t(pat)})
    Smax = jc.vis_tokens + 6
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == Smax
    for step, nt in enumerate(([1, 2], [3, 4])):
        nt = np.asarray(nt, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nt))
        before = tcache["k"][:, :, :-1].clone()
        tl, tcache = tm.decode_step(tp, tcache, t(nt))
        assert int(tcache["pos"]) == Smax + step + 1
        assert torch.equal(tcache["k"][:, :, :-1], before)
        close(tl, jl)
        for k in ("k", "v"):
            close(tcache[k], jcache[k], msg=k)


def test_hybrid_decode_writes_every_cache_leaf_in_place():
    jc, tc = configs("zamba2-1.2b")
    tm = build_model(tc)
    tp = carried(JT.Model(jc).init(0))
    toks = np.random.RandomState(1).randint(0, 256, (2, 8)).astype(np.int32)
    _, cache = tm.prefill(tp, {"tokens": t(toks)}, pad_to=12)
    assert tuple(cache["shared_k"].shape) == (
        tc.n_layers // tc.shared_attn_period, 2, 12, tc.n_kv_heads,
        tc.d_head)
    old = {k: (v, v.clone()) for k, v in cache.items() if k != "pos"}
    _, new = tm.decode_step(tp, cache, t(np.array([5, 6], np.int32)))
    for k, (buf, was) in old.items():
        assert new[k] is buf, k
        assert not torch.equal(buf, was), k
    assert int(new["pos"]) == 9


@pytest.mark.parametrize("arch,key,n", [("paligemma-3b", "patches", 8),
                                        ("seamless-m4t-large-v2", "frames",
                                         24)])
def test_engine_batch_carries_zero_stub_inputs(arch, key, n):
    """The engine's prefill batch has the reference's zero ``patches`` /
    ``frames`` [B, n, D] in the compute dtype, on the engine's device."""
    cfg = tget(arch).reduced()
    slots = [Request(rid=0, prompt=np.arange(5)), None]
    got = ServingEngine(cfg, batch_size=2, prompt_len=8,
                        device="cpu")._batchify(slots)
    want = JEngine(jget(arch).reduced(), batch_size=2,
                   prompt_len=8)._batchify(slots)
    assert got.keys() == want.keys() == {"tokens", key}
    assert tuple(got[key].shape) == tuple(want[key].shape) == (
        2, n, cfg.d_model)
    assert got[key].dtype == torch.bfloat16 and got[key].device.type == "cpu"
    assert not got[key].any()
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
