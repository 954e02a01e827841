"""``chip_smoke.py`` phase 7j on the CPU: Mamba2 served over the QoS fabric.

The card serves Mamba2-2.7B at full width on phase 7h's traffic (24
requests, seed 17) and fabric.  The engine's events follow from the batch
and the ``max_new_tokens`` draws alone, so the same traffic through
mamba2-2.7b ``.reduced()`` at prompt_len 16 (two ssm chunks of 8) gives the
counts the card holds: ``LLAMA_COUNTS``, on the port's engine and fabric
and on the reference's.  The port's run also holds phase 7j's cache
bounds (a prefill of one chunk then a chunk of decode steps against a
prefill of two).
"""
import importlib.util
import pathlib

import numpy as np

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = dict(prompt_len=16, prompt_min=4, max_len=72, check_prefill=8,
               check_decode=8)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ssm_serving_counts_on_the_port():
    from repro_torch.configs import get_config

    cs = _smoke()
    cfg = get_config(cs.SSM_SERVE["arch"]).reduced()
    spec = dict(cs.SSM_SERVE, **REDUCED)
    assert spec["check_prefill"] == cfg.ssm_chunk
    res = cs.serve_fullwidth("cpu", cfg, spec)
    assert cs.llama_counts(res) == cs.LLAMA_COUNTS
    assert res["all_finite"]
    for key, dt in (("cache_check", cfg.compute_dtype),
                    ("cache_check_f32", "float32")):
        for k, bound in cs.SSM_CACHE_REL_L2[dt].items():
            assert res[key][k] <= bound, (dt, k, res[key])


def test_ssm_serving_counts_are_the_reference():
    """The reference's engine and fabric (jax) on the same traffic give the
    same counts."""
    from repro.configs import get_config
    from repro.serving.engine import Request, ServingEngine
    from repro.serving.qos import ServingQos, TrafficClass

    cs = _smoke()
    c = dict(cs.SSM_SERVE, **REDUCED)
    cfg = get_config(c["arch"]).reduced()
    qos = ServingQos(**cs.LLAMA_QOS)
    eng = ServingEngine(cfg, batch_size=c["batch"],
                        prompt_len=c["prompt_len"], max_len=c["max_len"],
                        qos=qos)
    for r in cs.llama_requests(c, cfg.vocab):
        eng.submit(Request(rid=r.rid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens))
    done = eng.run()
    bg = qos.tenants[TrafficClass.BACKGROUND]
    res = dict(eng.stats, requests=len(done),
               drain_supersteps=qos.drain(),
               background=[bg.completed, bg.submitted],
               ticked=qos.summary()["supersteps"])
    assert cs.llama_counts(res) == cs.LLAMA_COUNTS
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
    assert all(np.isfinite(r.out_tokens).all() for r in done)
