"""The port's composite example (``repro_torch.examples.
hierarchical_allreduce``) against the reference's script on the CPU, as
``test_torch_examples_fabric.py`` does; and every example's default
device: ``cuda``, raising without a card.
"""
import importlib
import re

import pytest
import torch

from torch_parity import ROOT, one_torch_thread  # noqa: F401 (autouse)
from torch_parity import example_numbers as numbers
from torch_parity import run_against_reference

EXAMPLES = ("quickstart", "adversarial_orders", "elastic_shrink",
            "hierarchical_allreduce", "moe_alltoall", "overlap_training",
            "serve_batched", "train_dp_occl")


def test_hierarchical_allreduce(capsys, tmp_path):
    """Both packages' ``auto`` rank plans with the reference's calibration
    (the port reads it through ``REPRO_TORCH_CALIBRATION``)."""
    cal = tmp_path / "calibration.json"
    cal.write_bytes((ROOT / "BENCH_calibration.json").read_bytes())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_CALIBRATION", str(cal))
        res, ref = run_against_reference(
            "hierarchical_allreduce", capsys,
            env={"REPRO_TORCH_CALIBRATION": str(cal)})
    assert res["chain"] == [0, 1, 2]
    assert res["stage_completions"] == numbers(
        r"per-stage completions \[(\d+), (\d+), (\d+)\]", ref) \
        == [32, 32, 32]
    assert res["logical_cqes"] == numbers(
        r"logical CQEs only at the tail \[(\d+), (\d+), (\d+)\]", ref) \
        == [0, 0, 32]
    assert [res["steps"]["ring"], res["steps"]["two_level"]] == numbers(
        r"flat ring (\d+), two-level (\d+)", ref) == [31, 15]
    picks = re.search(r"64 elems -> (\w+), 65536 elems -> (\w+)", ref)
    assert [res["auto"][64], res["auto"][1 << 16]] == list(picks.groups())
    assert res["static"] == {"deadlocked": True, "cycle": [0, 1]}
    assert [res["preempts"], res["launches"]] == numbers(
        r"(\d+) preemptions, (\d+) daemon launches", ref) == [96, 1]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name):
    """With no ``--device`` an example runs on ``cuda``: without a card it
    raises before it builds anything, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main([])


@pytest.mark.parametrize("name", ["quickstart", "elastic_shrink",
                                  "hierarchical_allreduce",
                                  "overlap_training"])
def test_chip_smoke_example_counts(name):
    """``chip_smoke.py`` phase x on the CPU for the cheaper examples: the
    port's example holds ``EXAMPLE_COUNTS`` (the reference's counts)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    argv = dict(cs.EXAMPLES)[name]
    res = cs.phase_example(name, argv, "cpu", "cpu")
    assert res["fabric"]["supersteps"] > 0
