"""``chip_smoke.py`` phases 7g and 7h on the CPU: the functions the card
runs, at a cost the CPU can pay.

* 7g (``repro_torch.examples.serve_batched``, llama3-8b ``.reduced()``):
  the port's example gives ``SERVE_BATCHED_COUNTS``, and so does the
  reference's engine and fabric on the same traffic, so the card can hold
  the reference's numbers.
* 7h (Llama-3-8B served at full width): the same traffic through the
  reduced model (prompt_len 16 instead of 1024; the counts follow from the
  batch and the ``max_new_tokens`` draws alone) gives ``LLAMA_COUNTS``, and
  both cache checks pass.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_counts_on_the_port():
    from repro_torch.examples import serve_batched

    cs = _smoke()
    res = serve_batched.main(["--device", "cpu"])
    assert cs.serve_batched_counts(res) == cs.SERVE_BATCHED_COUNTS
    on, off = res["preempt_on"]["qos"], res["preempt_off"]["qos"]
    assert on["decode"]["p99"] < off["decode"]["p99"]
    assert res["mid_burst"]["preempts"] > 0


@pytest.mark.parametrize("part", ["preempt_off", "preempt_on_and_mid_burst"])
def test_serve_batched_counts_are_the_reference(part):
    """``examples/serve_batched.py``'s parts 1-3 on the reference's engine
    and fabric (jax) give the counts the card holds."""
    from repro.configs import get_config
    from repro.serving.engine import Request, ServingEngine
    from repro.serving.qos import ServingQos, TrafficClass
    from repro_torch.examples import serve_batched as ex

    cs = _smoke()
    want = cs.SERVE_BATCHED_COUNTS
    c = ex.parse_args([])
    cfg = get_config(c.arch).reduced()

    def reqs():
        rng = np.random.RandomState(0)
        return [Request(rid=i,
                        prompt=rng.randint(0, cfg.vocab,
                                           size=rng.randint(4, 16)),
                        max_new_tokens=c.max_new)
                for i in range(c.requests)]

    def engine(qos=None):
        e = ServingEngine(cfg, batch_size=ex.BATCH,
                          prompt_len=ex.PROMPT_LEN, qos=qos)
        for r in reqs():
            e.submit(r)
        e.run()
        return e

    keep = ("prefills", "decode_steps", "tokens", "admissions")
    pres = [False] if part == "preempt_off" else [True]
    if part != "preempt_off":
        e = engine()
        assert {k: e.stats[k] for k in keep} == want["alone"]
    for pre in pres:
        qos = ServingQos(**ex.QOS, preemption=pre)
        e = engine(qos)
        qos.drain()
        bg = qos.tenants[TrafficClass.BACKGROUND]
        got = {"qos": e.stats.pop("qos"),
               "background": [bg.completed, bg.submitted],
               "ticked": qos.summary()["supersteps"],
               **{k: e.stats[k] for k in keep}}
        key = "preempt_on" if pre else "preempt_off"
        assert cs.no_nan(got) == want[key]
    if part != "preempt_off":
        qos = ServingQos(**ex.MID_BURST_QOS)
        qos.submit_background()
        qos.advance(2)
        lat = qos.wait(qos.submit_decode())
        qos.drain()
        assert {"latency": lat, "preempts": qos.summary()["preempts"],
                "supersteps": qos.summary()["supersteps"]} \
            == want["mid_burst"]


def test_serve_fullwidth_counts_at_reduced_size():
    from repro_torch.configs import get_config

    cs = _smoke()
    cfg = get_config(cs.LLAMA_SERVE["arch"]).reduced()
    spec = dict(cs.LLAMA_SERVE, prompt_len=16, prompt_min=4, max_len=72)
    res = cs.serve_fullwidth("cpu", cfg, spec)
    assert cs.llama_counts(res) == cs.LLAMA_COUNTS
    assert res["all_finite"]
    assert res["cache_check"]["rel_l2"] <= cs.CACHE_CHECK_REL_L2["bfloat16"]
    assert res["cache_check_f32"]["rel_l2"] \
        <= cs.CACHE_CHECK_REL_L2["float32"]
    # The traffic recycles slots mid-flight: more admission events than a
    # cohort engine's ceil(24 / 8).
    assert res["prefills"] > 3


def test_llama_traffic_counts_do_not_depend_on_prompt_lengths():
    cs = _smoke()
    a = cs.llama_requests(cs.LLAMA_SERVE, 128256)
    b = cs.llama_requests(dict(cs.LLAMA_SERVE, prompt_len=16, prompt_min=4),
                          256)
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert all(256 <= len(r.prompt) <= 1024 for r in a)
    assert all(8 <= r.max_new_tokens <= 48 for r in a)
