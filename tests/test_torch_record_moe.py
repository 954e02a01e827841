"""The record's MoE cell (``BENCH_collectives.json`` -> ``training.moe``),
the full-width MoE cell's code path and grad-sync eviction on the port,
run through the same functions ``chip_smoke.py`` runs on the card, here on
the CPU: exactly the record's superstep and tick-call counts (barrier 360
in 2 tick calls; overlapped 320 = 256 exposed + 64 hidden in 31), the
barrier output bit-equal to ``ep_forward_ref``; the full-width cell's
checks on the reduced config (float64 recomputation at rtol 1e-4 / atol
1e-5, every exchange once per rank, real capacity drops)."""
import importlib.util
import json
import pathlib

import pytest

from repro_torch.configs import get_config
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_collectives.json").read_text())[
    "training"]["moe"]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forward_overlapped_shortens_critical_path():
    """The record's counts, and the overlap claim behind them: the
    overlapped forward exposes strictly fewer supersteps than the barrier
    forward, whose supersteps are all exposed."""
    cs = _smoke()
    c = RECORD["config"]
    assert (c["n_ranks"], c["tokens_per_rank"], c["cap"], c["n_streams"],
            c["overlap_ticks"]) == tuple(
        cs.MOE_RECORD[k] for k in ("R", "tokens", "cap", "n_streams",
                                   "overlap_ticks"))
    res = cs.moe_record("cpu")
    for mode in ("barrier", "overlap"):
        want = {k: RECORD[mode][k] for k in cs.MOE_STEPS[mode]}
        assert want == cs.MOE_STEPS[mode]
        assert {k: res[mode][k] for k in want} == want, mode
    assert res["overlap"]["exposed_supersteps"] \
        < res["barrier"]["exposed_supersteps"]
    assert res["barrier_bitwise"] and res["overlap_close"]


def test_moe_fullwidth_cell_on_reduced_config():
    """The full-width cell's function on deepseek-moe-16b reduced at its
    own capacity factor (64 tokens per rank, cap 20, slices of 64)."""
    cs = _smoke()
    cfg = get_config("deepseek-moe-16b").reduced()
    assert cfg.capacity_factor == 1.25
    res = cs.moe_fullwidth("cpu", cfg, 64, 64, seed=3)
    assert res["cap"] == 20
    assert 0.0 < res["dropped_share"] < 0.2
    assert res["barrier"]["bitwise_vs_ep_ref"]
    split = res["barrier"]["split_s"]
    assert split["daemon"] > 0 and min(split.values()) >= 0
    assert sum(split.values()) == pytest.approx(res["barrier"]["wall_s"])
    for mode in ("barrier", "overlap"):
        r = res[mode]
        assert r["supersteps"] > 0
        # On the CPU the wrapper runs the plain version: no kernel launch.
        assert r["fused_burst_launches"] == 0
        assert r["float64_max_abs_err"] <= 1e-5
    assert res["overlap"]["hidden_supersteps"] > 0


def test_moe_fullwidth_config_is_the_published_block():
    cs = _smoke()
    cfg = get_config(cs.MOE_FULL["arch"])
    assert (cfg.d_model, cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
            cfg.d_ff_expert, cfg.capacity_factor, cfg.param_dtype) == (
        2048, 64, 6, 2, 1408, 1.25, "float32")
    from repro_torch.train.occl_moe import _capacity
    cap = _capacity(cs.MOE_FULL["tokens"], cfg.top_k, cfg.n_experts,
                    cfg.capacity_factor)
    assert cap == 480
    n = cfg.n_experts * cap * cfg.d_model
    assert 10 * n == cs.MOE_FULL_RUNTIME["heap_elems"]
    assert cs.MOE_FULL_RUNTIME["R"] * (10 * n) > 2 ** 31
    assert (n // cs.MOE_FULL_RUNTIME["R"]) % cs.MOE_FULL["slice_elems"] == 0


def test_grad_sync_evict_and_stale_device_api():
    cs = _smoke()
    res = cs.grad_sync_evict("cpu")
    assert res["n_ranks"] == 3 and res["stale_refused"]
    assert res["max_abs_err"] < 1e-5
