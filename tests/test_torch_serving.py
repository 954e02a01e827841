"""The port's serving path against the reference, on reduced configs.

Parameters are carried across from the reference's init
(``repro_torch.models.convert``): the two RNGs differ.  Tolerances:

* ``decode_attention`` in float32 at ``rtol=1e-5`` (``atol=1e-6`` for
  entries near zero);
* ``prefill`` / ``decode_step`` with ``compute_dtype="float32"``: logits
  and every cache leaf at ``rtol=1e-5, atol=1e-6`` (float32 summation
  orders inside matmuls and reductions are the only differences); in the
  configs' own bfloat16, each within ``BF16_REL_L2`` of the reference in
  relative L2 norm (bf16 matmul outputs round at 2^-8, so one
  activation's one-ulp difference moves everything downstream of it);
* prefill of S tokens then one decode step against the last position of a
  prefill over the same S + 1 tokens (the check ``chip_smoke.py`` phase 7h
  runs at full width): relative L2 within ``CACHE_REL_L2`` of the compute
  dtype, and in float32 against the reference's prefill at ``rtol=1e-5``;
* the engines: the same tokens per request, the same completion order, the
  same stats and a bit-equal QoS digest (the fabric is structural).
"""
import contextlib
import dataclasses
import importlib.util
import io
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro_torch.models.attention as TA
from repro.configs import get_config as jget
from repro.models.transformer import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.qos import ServingQos as JQos
from repro_torch.configs import get_config as tget
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import (Request, ServingEngine, ServingQos,
                                 TrafficClass)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVING_ARCHS = ("qwen3-0.6b", "llama3-8b", "h2o-danube-3-4b",
                 "deepseek-moe-16b", "zamba2-1.2b", "paligemma-3b",
                 "seamless-m4t-large-v2")
BF16_REL_L2 = 5e-2
CACHE_REL_L2 = {"float32": 1e-4, "bfloat16": 5e-2}
PAD_TO, PROMPT, DECODE_STEPS = 14, 12, 3


def lengths(cfg) -> tuple[int, int]:
    """(prompt, pad_to) of :func:`serve_both`: an ssm trunk takes whole
    chunks (16 = two of 8); a vlm cache also holds the image; the last
    decode step runs past the padded cache."""
    prompt = 16 if cfg.ssm_state else PROMPT
    return prompt, prompt + PAD_TO - PROMPT + cfg.vis_tokens


def stub_inputs(cfg, batch: int, rng) -> dict:
    """Seeded non-zero ``patches`` / ``frames`` (numpy float32)."""
    n = {"vlm": ("patches", cfg.vis_tokens),
         "encdec": ("frames", cfg.enc_frames)}.get(cfg.family)
    if n is None:
        return {}
    return {n[0]: rng.randn(batch, n[1], cfg.d_model).astype(np.float32)}


def configs(arch, compute_dtype=None):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    if compute_dtype:
        jc = dataclasses.replace(jc, compute_dtype=compute_dtype)
        tc = dataclasses.replace(tc, compute_dtype=compute_dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def carried(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def rel_l2(got, want) -> float:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("pos", [0, 5, 11, 14])     # Smax = 12
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_matches_reference(g, pos, window):
    rng = np.random.RandomState(100 * g + 10 * pos + window)
    B, Smax, Hkv, dh = 2, 12, 2, 8
    q = rng.randn(B, 1, Hkv * g, dh).astype(np.float32)
    k = rng.randn(B, Smax, Hkv, dh).astype(np.float32)
    v = rng.randn(B, Smax, Hkv, dh).astype(np.float32)
    want = JA.decode_attention(q, k, v, jnp.int32(pos), window=window)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              torch.tensor(pos, dtype=torch.int32),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Model.prefill / Model.decode_step
# ---------------------------------------------------------------------------

def serve_both(arch, compute_dtype):
    """Prefill (``pad_to``) and ``DECODE_STEPS`` decode steps on both
    packages from the same params, tokens and seeded ``patches`` /
    ``frames``; yields (label, reference output, port output) for the
    logits and every cache leaf after each call.  The last step runs past
    the padded cache (pos >= Smax)."""
    jc, tc = configs(arch, compute_dtype)
    jm, tm = JModel(jc), build_model(tc)
    jp = jm.init(0)
    tp = carried(jp)
    prompt, pad_to = lengths(tc)
    rng = np.random.RandomState(7)
    batch = dict(stub_inputs(jc, 2, rng), tokens=rng.randint(
        0, jc.vocab, (2, prompt)).astype(np.int32))
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, pad_to=pad_to))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = tm.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, pad_to=pad_to)
    assert tuple(tl.shape) == (2, 1, jl.shape[-1])
    assert tcache.keys() == jcache.keys()
    leaves = sorted(k for k in jcache if k != "pos")
    for k in leaves:
        assert tuple(tcache[k].shape) == tuple(jcache[k].shape), k
    if "k" in tcache:
        assert tuple(tcache["k"].shape) == (tc.n_layers, 2, pad_to,
                                            tc.n_kv_heads, tc.d_head)
    out = [("prefill logits", jl, tl)]
    # decode_step writes the port's cache in place: compare copies
    out += [(f"prefill cache {k}", jcache[k], tcache[k].clone())
            for k in leaves]
    pos = prompt + tc.vis_tokens
    assert int(tcache["pos"]) == int(jcache["pos"]) == pos
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    dec = jax.jit(jm.decode_step)
    for step in range(DECODE_STEPS):
        nt = rng.randint(0, jc.vocab, (2,)).astype(np.int32)
        jl, jcache = dec(jp, jcache, jnp.asarray(nt))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(nt))
        assert int(tcache["pos"]) == int(jcache["pos"]) == pos + step + 1
        out.append((f"decode {step} logits", jl, tl))
        out += [(f"decode {step} cache {k}", jcache[k], tcache[k].clone())
                for k in leaves]
    return out


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_prefill_decode_float32(arch):
    for label, want, got in serve_both(arch, "float32"):
        assert got.dtype == torch.float32, label
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                   atol=1e-6, err_msg=label)


@pytest.mark.parametrize("arch", SERVING_ARCHS)
def test_prefill_decode_bfloat16(arch):
    assert tget(arch).compute_dtype == "bfloat16"
    for label, want, got in serve_both(arch, None):
        if "cache" in label:
            assert got.dtype == (torch.float32 if "state" in label
                                 else torch.bfloat16), label
        err = rel_l2(got, want)
        assert err < BF16_REL_L2, (label, err)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_equals_longer_prefill(compute_dtype):
    """``chip_smoke.cache_check`` at a reduced size, and in float32 the
    port's decode-step logits against the reference's prefill over the
    same S + 1 tokens."""
    cs = smoke()
    assert cs.CACHE_CHECK_REL_L2 == CACHE_REL_L2
    jc, tc = configs("llama3-8b", compute_dtype)
    jm, tm = JModel(jc), build_model(tc)
    jp = jm.init(0)
    tp = carried(jp)
    toks = np.random.RandomState(3).randint(0, jc.vocab, (4, 17)).astype(
        np.int32)
    res = cs.cache_check(tm, tp, torch.from_numpy(toks), 24)
    assert res["rel_l2"] <= CACHE_REL_L2[compute_dtype], res
    if compute_dtype == "float32":
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                              pad_to=24)
        got, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, 16]))
        want, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,error,match", [
    ("vit-base", ValueError, "vit")])
def test_serving_families_checked_first(arch, error, match):
    m = build_model(tget(arch).reduced())
    with pytest.raises(error, match=match):
        m.prefill({}, {})
    with pytest.raises(error, match=match):
        m.decode_step({}, {}, None)


# ---------------------------------------------------------------------------
# the engine: tests/test_serving.py on the port
# ---------------------------------------------------------------------------

def _reqs(n, vocab, seed=0, max_new=5, cls=Request):
    rng = np.random.RandomState(seed)
    return [cls(rid=i, prompt=rng.randint(0, vocab, size=rng.randint(3, 12)),
                max_new_tokens=max_new) for i in range(n)]


def engine(arch="qwen3-0.6b", **kw):
    return ServingEngine(tget(arch).reduced(), device="cpu", **kw)


def test_engine_drains_queue_multiple_batches():
    eng = engine(batch_size=3, prompt_len=12, max_len=24)
    for r in _reqs(7, eng.cfg.vocab):
        eng.submit(r)
    done = eng.run()
    assert len(done) == 7
    assert all(len(r.out_tokens) == 5 for r in done)
    # Uniform max_new: slots free together, so continuous batching still
    # admits in ceil(7/3) cohorts.
    assert eng.stats["prefills"] == 3
    assert eng.stats["tokens"] == sum(len(r.out_tokens) for r in done)


def test_engine_recycles_slots_mid_flight():
    """The long request does not hold the short ones' slots: freed slots
    re-admit from the queue while it keeps decoding, and the token counter
    reconciles exactly with the emitted tokens."""
    eng = engine(batch_size=2, prompt_len=12, max_len=24)
    reqs = _reqs(4, eng.cfg.vocab, seed=1)
    for r, n in zip(reqs, [8, 2, 2, 2]):
        r.max_new_tokens = n
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 4
    assert sorted(len(r.out_tokens) for r in done) == [2, 2, 2, 8]
    assert done[-1].rid == 0
    # One re-prefill per admission event: {0,1}, {0,2}, {0,3}.
    assert eng.stats["admissions"] == 4
    assert eng.stats["prefills"] == 3
    assert eng.stats["tokens"] == sum(len(r.out_tokens) for r in done)


def test_engine_token_stats_reconcile_with_zero_token_requests():
    """max_new_tokens=0 retires at admission with zero tokens."""
    eng = engine(batch_size=2, prompt_len=12, max_len=24)
    reqs = _reqs(3, eng.cfg.vocab, seed=2)
    reqs[1].max_new_tokens = 0
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    assert len(done) == 3
    assert eng.stats["tokens"] == sum(len(r.out_tokens) for r in done)
    assert next(r for r in done if r.rid == 1).out_tokens == []
    assert {r.rid for r in done} == {0, 1, 2}


def qos_kw(preemption=True):
    return dict(n_ranks=2, decode_elems=64, prefill_elems=128,
                background_elems=1024, background_buckets=1,
                preemption=preemption)


def test_engine_with_qos_fabric():
    """Every prefill issues the all-gather and every decode step the
    all-reduce on the shared fabric; the stats gain the digest."""
    qos = ServingQos(**qos_kw(), device="cpu")
    eng = engine(batch_size=2, prompt_len=12, max_len=24, qos=qos)
    for r in _reqs(3, eng.cfg.vocab, max_new=3):
        eng.submit(r)
    done = eng.run()
    assert len(done) == 3
    q = eng.stats["qos"]
    assert q["decode"]["completed"] == eng.stats["decode_steps"]
    assert q["prefill"]["completed"] == eng.stats["prefills"]
    qos.drain()     # background bursts pumped mid-run must all land
    bg = qos.tenants[TrafficClass.BACKGROUND]
    assert bg.submitted > 0 and bg.completed == bg.submitted


def test_engine_deterministic():
    def run():
        eng = engine("llama3-8b", batch_size=2, prompt_len=8, max_len=16)
        for r in _reqs(2, eng.cfg.vocab, seed=3):
            eng.submit(r)
        return [r.out_tokens for r in eng.run()]

    assert run() == run()


def test_engine_and_launcher_need_a_card_by_default(monkeypatch):
    """No fallback: without a device argument the engine and the launcher
    run on cuda, and raise where there is no card."""
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tget("qwen3-0.6b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--requests", "1"])


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

def record_logits(eng) -> list:
    """Shadow the engine's prefill and decode calls so that each call's
    logits (last position, float32 numpy) are kept, in call order."""
    seen = []

    def wrap(fn, last):
        def call(*a):
            logits, cache = fn(*a)
            seen.append(f32(logits[:, -1] if last else logits))
            return logits, cache
        return call

    eng._prefill = wrap(eng._prefill, True)
    eng._decode = wrap(eng._decode, False)
    return seen


def both_engines(arch, n, seed, max_new, qos=None, **kw):
    """The reference's and the port's engines (float32 compute, the
    reference's params carried across) over the same requests."""
    jc, tc = configs(arch, "float32")
    out = []
    for side in ("ref", "port"):
        if side == "ref":
            q = None if qos is None else JQos(**qos)
            eng = JEngine(jc, qos=q, **kw)
            reqs = _reqs(n, jc.vocab, seed, cls=JRequest)
        else:
            q = None if qos is None else ServingQos(**qos, device="cpu")
            eng = ServingEngine(tc, qos=q, device="cpu", **kw)
            eng.load_params(carried(out[0][0].params))
            reqs = _reqs(n, tc.vocab, seed)
        for r, m in zip(reqs, max_new):
            r.max_new_tokens = m
        logits = record_logits(eng)
        for r in reqs:
            eng.submit(r)
        done = eng.run()
        out.append((eng, done, logits))
    return out


def first_divergence(jl: list, tl: list) -> str:
    """Where the two engines' greedy tokens first differ, the reference's
    top-2 logit margin there."""
    for i, (a, b) in enumerate(zip(jl, tl)):
        if not (a.argmax(-1) == b.argmax(-1)).all():
            row = int(np.argmax(a.argmax(-1) != b.argmax(-1)))
            top = np.sort(a[row])[-2:]
            return (f"call {i}, row {row}: top-2 margin {top[1] - top[0]:.3g}"
                    f", port - reference max {np.abs(a - b).max():.3g}")
    return "no greedy token differs"


def assert_digest_equal(got: dict, want: dict) -> None:
    """Two ``ServingQos.summary()`` digests bit for bit (NaN == NaN)."""
    cs = smoke()
    assert cs.no_nan(got) == cs.no_nan(want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "zamba2-1.2b", "paligemma-3b",
                                  "seamless-m4t-large-v2"])
def test_engine_matches_reference_float32(arch):
    """The vlm and encdec engines send zero ``patches`` / ``frames`` on
    both sides; an ssm trunk takes whole chunks (prompt_len 16)."""
    prompt = lengths(tget(arch).reduced())[0]
    (jeng, jdone, jl), (teng, tdone, tl) = both_engines(
        arch, 5, 4, [6, 2, 3, 1, 4], batch_size=2, prompt_len=prompt,
        max_len=prompt + 12)
    why = first_divergence(jl, tl)
    assert [r.rid for r in tdone] == [r.rid for r in jdone], why
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone], \
        why
    assert teng.stats == jeng.stats
    assert len(tl) == len(jl) == teng.stats["prefills"] \
        + teng.stats["decode_steps"]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preemption", [True, False])
def test_engine_qos_digest_equals_reference(preemption):
    (jeng, jdone, _), (teng, tdone, _) = both_engines(
        "qwen3-0.6b", 3, 0, [3, 3, 3], qos=qos_kw(preemption),
        batch_size=2, prompt_len=12, max_len=24)
    jq, tq = jeng.stats.pop("qos"), teng.stats.pop("qos")
    assert_digest_equal(tq, jq)
    assert teng.stats == jeng.stats
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    tdrain, jdrain = teng.qos.drain(), jeng.qos.drain()
    assert tdrain == jdrain
    assert_digest_equal(teng.qos.summary(), jeng.qos.summary())


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------

def untimed(text: str) -> str:
    """A launcher's printout without its wall-clock figures."""
    return re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)", "", text)


@pytest.mark.parametrize("qos", [False, True])
def test_launch_serve_matches_reference(monkeypatch, qos):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--requests", "3", "--max-new", "4", "--batch", "2",
            "--prompt-len", "8"] + (["--qos"] if qos else [])
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jserve.main()
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        stats = tserve.main(args + ["--device", "cpu"])
    assert untimed(tout.getvalue()) == untimed(jout.getvalue())
    assert "3 requests, 12 tokens" in tout.getvalue()
    assert stats["tokens"] == 12 and ("qos" in stats) == qos
