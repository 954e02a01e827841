"""``chip_smoke.py`` phases 7k-7m on the CPU: the hybrid, vlm and encdec
families served over the QoS fabric.

The card serves Zamba2-1.2B, PaliGemma-3B and SeamlessM4T-large-v2 at full
width on phase 7h's traffic (24 requests, seed 17) and fabric.  The
engine's events follow from the batch and the ``max_new_tokens`` draws
alone, so the same traffic through each arch's ``.reduced()`` config at
prompt_len 16 gives the counts the card holds, ``LLAMA_COUNTS`` (the
reference's engine gives them on llama3-8b and mamba2-2.7b:
``tests/test_torch_record_engine.py``, ``tests/test_torch_record_ssm.py``).
The run also holds each phase's cache bounds (on seeded non-zero patches /
frames) and computes the phase's decode bytes and prefill FLOPs.
"""
import importlib.util
import pathlib

import pytest

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = {
    "serve hybrid": dict(prompt_len=16, prompt_min=4, max_len=72,
                         check_prefill=8, check_decode=8),
    "serve vlm": dict(prompt_len=16, prompt_min=4, max_len=8 + 16 + 56),
    "serve encdec": dict(prompt_len=16, prompt_min=4, max_len=72)}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tag", list(REDUCED))
def test_family_serving_counts_on_the_port(tag):
    from repro_torch.configs import get_config

    cs = _smoke()
    _, spec, bounds, train = next(p for p in cs.SERVE_FAMILIES
                                  if p[0] == tag)
    assert spec["prompt_len"] == cs.LLAMA_SERVE["prompt_len"]
    cfg = get_config(spec["arch"]).reduced()
    spec = dict(spec, **REDUCED[tag])
    res = cs.serve_fullwidth("cpu", cfg, spec)
    assert cs.llama_counts(res) == cs.LLAMA_COUNTS
    assert res["all_finite"]
    for key, dt in (("cache_check", cfg.compute_dtype),
                    ("cache_check_f32", "float32")):
        assert set(bounds[dt]) <= set(res[key]), res[key]
        for k, bound in bounds[dt].items():
            assert res[key][k] <= bound, (dt, k, res[key])
    cs.serving_costs(cfg, spec, res)
    cs.serving_times(res)
    assert res["decode_bytes"] > res["cache_bytes"] > 0
    assert res["prefill_flop"] > 2 * res["n_params"] // 2
    if tag == "serve hybrid":
        assert train is cs.SSM_TRAIN
        tr = cs.train_steps("cpu", cfg, dict(train, batch=2, seq=16))
        assert len(tr["losses"]) == train["steps"]
