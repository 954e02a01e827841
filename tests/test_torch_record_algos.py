"""The record's algos sweep (``BENCH_collectives.json`` ``algos``: R=16,
grid (4, 4), 256 and 16384 elements, bandwidth skew 4 islands / inter cap
2) on the port on the CPU, through the same function ``chip_smoke.py``
times on the card: every plan's superstep count and cost-model features
equal the record's."""
import importlib.util
import json
import pathlib

import pytest

import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "BENCH_collectives.json").read_text())
CELLS = [("all_reduce", "small"), ("all_reduce", "large"),
         ("broadcast", "small"), ("broadcast", "large")]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("label,size", CELLS)
def test_algos_sweep_counts_match_record(label, size):
    cs = _smoke()
    rec = RECORD["algos"]["sweep"][label][size]
    n = rec["n_elems"]
    kind = T.CollKind[label.upper()]
    for algo in cs.ALGO_STEPS[(label, n)]:
        got = cs.algo_once(T, "cpu", algo, kind, n, 64, bandwidth_groups=4,
                           inter_burst_cap=2)
        assert got["supersteps"] == rec[algo]["supersteps"] == \
            cs.ALGO_STEPS[(label, n)][algo], algo
        assert got["features"] == rec[algo]["features"], algo
