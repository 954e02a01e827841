"""Whole runs of each cell at a small size on the CPU, past the harness's
look for a card: sound runs come out correct; the control (the reference
one precision below the configuration's, in the program's place) and each
fault a cell can have, planted under the timed path, come out not correct.

Faults (``faults/<driver>.py``, one file per driver: ``FAULTS`` maps a
name to ``plant(monkeypatch, wl)``): a step that returns its state
unchanged (training cells only: a MoE forward keeps no state), half of
each rank's batch left out with the mean taken over the rest, the exchange
between ranks left out, and an answer altered where it is produced.
"""
import importlib.util

import pytest
import torch

import occl_bench_tiny as tiny
from occl_bench.harness import compare, standins

FAULT_DIR = tiny.BENCH / "tests" / "faults"


def faults_of(cell: str) -> dict:
    driver = tiny.workload(cell)["driver"]
    spec = importlib.util.spec_from_file_location(
        f"occl_bench_faults_{driver}", FAULT_DIR / f"{driver}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["step_s"] > 0


@pytest.mark.parametrize("cell", [c for c in tiny.CELLS if tiny.training(c)])
def test_training_window_holds_the_checked_steps(cell):
    fam = tiny.family_of(tiny.workload(cell)["config"])
    res = tiny.run(cell)
    # the window's first steps are among those the reference follows
    assert res["attempted"] == fam.CHECKED_STEPS - fam.WARM_STEPS
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in tiny.CELLS
                                        for f in faults_of(c)])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    faults_of(cell)[fault](monkeypatch, tiny.workload(cell))
    res = tiny.run(cell)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", tiny.first_cells())
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(cell, seed):
    wl = tiny.workload(cell)
    cfg = tiny.config(wl["config"])
    readings = standins.read(cfg, wl, seed, "cpu", "control")
    ok, checks = compare.judge(readings, wl["limits"])
    assert not ok, checks


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_has_its_faults(cell):
    # every fault the cell can have is planted: the unchanged state where
    # its family trains
    want = {"half_batch", "no_exchange", "answer_altered"}
    if tiny.training(cell):
        want.add("unchanged")
    assert set(faults_of(cell)) == want
