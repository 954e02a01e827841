"""The record's composite, all-to-all and reliability counts on the port at
R=16 / R=8 (``BENCH_collectives.json`` sections ``hierarchy``,
``alltoall`` and ``reliability``), run through the same functions
``chip_smoke.py`` runs on the card, here on the CPU.  The reference's
counts come from the record instead of compiling the JAX daemon at R=16.
"""
import importlib.util
import json
import pathlib

import pytest

import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_collectives.json").read_text())


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("algo", ["ring", "two_level"])
def test_hierarchy_counts_match_record(algo):
    cs = _smoke()
    rec = RECORD["hierarchy"]
    assert (rec["config"]["n_elems"], rec["config"]["conn_depth"]) == \
        (2048, 24)
    got = cs.algo_once(T, "cpu", algo, T.CollKind.ALL_REDUCE, 2048, 24)
    want = rec["flat" if algo == "ring" else "two_level"]
    assert got["supersteps"] == want["supersteps"] == cs.HIER_STEPS[algo]
    assert got["features"] == want["features"]


@pytest.mark.parametrize("algo", ["ring", "two_level"])
def test_alltoall_counts_match_record(algo):
    cs = _smoke()
    rec = RECORD["alltoall"]
    got = cs.algo_once(T, "cpu", algo, T.CollKind.ALL_TO_ALL,
                       rec["config"]["n_elems"], rec["config"]["conn_depth"],
                       bandwidth_groups=4, inter_burst_cap=2)
    want = rec["flat" if algo == "ring" else "two_level"]
    assert got["supersteps"] == want["supersteps"] == cs.A2A_STEPS[algo]
    assert got["features"] == want["features"]


def test_alltoall_mix_matches_record():
    cs = _smoke()
    want = RECORD["alltoall"]["contention"]["supersteps"]
    assert cs.a2a_mix(T, "cpu") == want == cs.A2A_MIX_STEPS


def test_evict_loop_matches_record():
    """Hang -> diagnosis naming rank 5 -> evict(5) -> 520 supersteps,
    bit-equal to a fresh 7-rank runtime."""
    cs = _smoke()
    rec = RECORD["reliability"]["evict"]
    got = cs.evict_loop(T, "cpu")
    assert got["holders"] == [rec["config"]["evicted_rank"]]
    assert got["supersteps"] == got["fresh_supersteps"] == \
        rec["evicted_supersteps"] == cs.EVICT_STEPS
    assert got["bit_equal"]
    assert got["report"]["replayed"] == rec["replayed"]
    assert got["report"]["dropped"] == rec["dropped"]
