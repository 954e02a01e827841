"""The port's Mamba2 (ssm) family against the reference, on mamba2-2.7b
``.reduced()`` (2 layers, d_model 64, 8 heads of 16, state 16, chunk 8).

Parameters are carried across from the reference's init
(``models/convert.py``); inputs are seeded numpy.  Every comparison runs in
float32 and holds ``rtol=1e-5, atol=1e-6`` (the two packages differ only in
float32 summation orders), gradients ``rtol=1e-4, atol=1e-6`` (relative to
values near 1e-3, a few ulps of the sums behind them).  ``groups=2`` runs
the grouped B / C (two heads per group pair through ``repeat_interleave``,
as in the full config's 80 heads over 8 groups).  The chunk-boundary cache
check (a prefill then a chain of decode steps against one longer prefill)
holds ``chip_smoke.py``'s bounds in bfloat16 and float32, the ones its
phase 7j holds at full width.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
import repro_torch.models.ssm as TS
from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_map
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCH = "mamba2-2.7b"
ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


def configs(compute_dtype="float32", **over):
    jc = dataclasses.replace(jget(ARCH).reduced(), compute_dtype=compute_dtype,
                             **over)
    tc = dataclasses.replace(tget(ARCH).reduced(), compute_dtype=compute_dtype,
                             **over)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def block(groups, seed=0):
    """One ssm block's params (reference init) on both sides."""
    jc, tc = configs(ssm_groups=groups)
    jp = JS.init_ssm_block(jax.random.PRNGKey(seed), "t", jc, jnp.float32)
    return jc, jp, tc, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def inputs(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    u, w, b = inputs((2, 6, 12), 0), inputs((4, 12), 1), inputs((12,), 2)
    st = inputs((2, 3, 12), 3) if with_state else None
    jy, jst = JS._causal_conv(u, w, b, st)
    ty, tst = TS._causal_conv(t(u), t(w), t(b),
                              None if st is None else t(st))
    close(ty, jy)
    close(tst, jst)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [4, 24])   # one short chunk; three chunks
def test_ssd_forward_matches_reference(groups, S):
    jc, jp, tc, tp = block(groups)
    x = inputs((2, S, jc.d_model), S)
    jy, (js, jcv) = jax.jit(JS.ssd_forward, static_argnums=0)(
        jc, jp, jnp.asarray(x))
    ty, (ts, tcv) = TS.ssd_forward(tc, tp, t(x))
    close(ty, jy)
    assert ts.dtype == torch.float32
    close(ts, js)
    for a, b in zip(tcv, jcv):
        close(a, b)


def test_ssd_forward_refuses_a_partial_chunk():
    _, _, tc, tp = block(1)
    with pytest.raises(ValueError, match="ssm_chunk"):
        TS.ssd_forward(tc, tp, torch.zeros(1, 12, tc.d_model))


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_decode_step_matches_reference(groups):
    jc, jp, tc, tp = block(groups)
    H, P, N = jc.ssm_heads, jc.ssm_headdim, jc.ssm_state
    GN, K1 = jc.ssm_groups * N, jc.ssm_dconv - 1
    x = inputs((2, 1, jc.d_model), 5)
    st = (inputs((2, H, N, P), 6),
          (inputs((2, K1, jc.d_inner), 7), inputs((2, K1, GN), 8),
           inputs((2, K1, GN), 9)))
    jy, (js, jcv) = jax.jit(JS.ssd_decode_step, static_argnums=0)(
        jc, jp, jnp.asarray(x), st)
    ty, (ts, tcv) = TS.ssd_decode_step(
        tc, tp, t(x), (t(st[0]), tuple(t(c) for c in st[1])))
    close(ty, jy)
    close(ts, js)
    for a, b in zip(tcv, jcv):
        close(a, b)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_forward_grads_match_reference(groups):
    """Gradients through the chunked scan (the -inf mask before ``exp``
    keeps them finite) against ``jax.grad``."""
    jc, jp, tc, tp = block(groups)
    x = inputs((2, 16, jc.d_model), 11)
    r = inputs((2, 16, jc.d_model), 12)

    def jloss(p, x):
        y, (st, _) = JS.ssd_forward(jc, p, x)
        return jnp.sum(y * r) + jnp.sum(st)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = t(x).requires_grad_()
    y, (st, _) = TS.ssd_forward(tc, tp, tx)
    (torch.sum(y * t(r)) + torch.sum(st)).backward()
    close(tx.grad, jgx, rtol=1e-4)
    for k in sorted(jg):
        assert bool(torch.isfinite(tp[k].grad).all()), k
        close(tp[k].grad, jg[k], rtol=1e-4)


# ---------------------------------------------------------------------------
# the ssm Model: init, prefill / decode_step, the cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jc, tc = configs()
    jm, tm = jbuild(jc), build_model(tc)
    jp = jm.init(0)
    jm.prefill, jm.decode_step = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    return jm, jp, tm, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def test_init_constants_equal_reference(models):
    """The port's own init draws other random values, but its constant
    leaves (``A_log``, ``D_skip``, ``dt_bias``, the norms and conv biases)
    are the reference's, within one float32 ulp (``A_log``: numpy's and
    XLA's ``log(linspace)``); the carried-over tree holds every leaf."""
    jm, jp, tm, tp = models
    mine = tm.init(0, "cpu")
    for k in ("A_log", "D_skip", "dt_bias", "norm", "gate_norm",
              "conv_x_b", "conv_B_b", "conv_C_b"):
        close(mine["layers"][k], jp["layers"][k], rtol=2 ** -23, atol=0)
        close(tp["layers"][k], jp["layers"][k], rtol=0, atol=0)
    assert sorted(mine["layers"]) == sorted(jp["layers"])


def test_prefill_and_decode_match_reference(models):
    jm, jp, tm, tp = models
    toks = np.random.RandomState(2).randint(0, 256, (3, 16)).astype(np.int32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": t(toks)}, pad_to=40)
    close(tl, jl)
    assert tcache.keys() == jcache.keys()
    assert int(tcache["pos"]) == 16
    for k in ("state", "conv_x", "conv_B", "conv_C"):
        assert tcache[k].shape == jcache[k].shape, k
        close(tcache[k], jcache[k])
    for i, nxt in enumerate(([3, 5, 7], [11, 13, 17])):
        nxt = np.asarray(nxt, np.int32)
        jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(nxt))
        tl, tcache = tm.decode_step(tp, tcache, t(nxt))
        close(tl, jl)
        assert int(tcache["pos"]) == 17 + i
        for k in ("state", "conv_x", "conv_B", "conv_C"):
            close(tcache[k], jcache[k])


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chunk_boundary_cache_check(models, compute_dtype):
    """A prefill of one chunk then a chain of one chunk's decode steps
    against a prefill of two chunks: ``chip_smoke.cache_check`` within
    phase 7j's bounds; in float32 the chain's last logits and state also
    equal the reference's chain."""
    cs = _smoke()
    jm, jp, _, tp = models
    tc = configs(compute_dtype)[1]
    Q = tc.ssm_chunk
    toks = np.random.RandomState(4).randint(0, 256, (2, 2 * Q)).astype(
        np.int32)
    cdt = getattr(torch, compute_dtype)
    params = tree_map(lambda a: a.to(cdt), tp)
    res = cs.cache_check(build_model(tc), params, t(toks), pad_to=None,
                         n_decode=Q)
    bound = cs.SSM_CACHE_REL_L2[compute_dtype]
    for k, v in bound.items():
        assert res[k] <= v, (k, res)
    if compute_dtype == "float32":
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :Q])})
        for i in range(Q, 2 * Q):
            jl, jcache = jm.decode_step(jp, jcache, jnp.asarray(toks[:, i]))
        tl, tcache = build_model(tc).prefill(
            tp, {"tokens": t(toks[:, :Q])})
        for i in range(Q, 2 * Q):
            tl, tcache = build_model(tc).decode_step(tp, tcache,
                                                     t(toks[:, i]))
        close(tl, jl)
        close(tcache["state"], jcache["state"])
