"""The port's training examples (``repro_torch.examples.overlap_training``
and ``.train_dp_occl``) against the reference's on the CPU.

``examples/overlap_training.py`` exits 1 in its act 2 (its overlapped MoE
forward is not bitwise equal to its ``ep_forward_ref``; the driver's
failing ``tests/test_occl_moe.py::test_forward_overlapped_bitwise_matches_
ref`` is the same divergence), so its counts are constants here.
``examples/train_dp_occl.py --steps 12 --tiny`` runs in a subprocess beside
the port's; the losses differ (the two packages draw other initial
weights), the counts must not.
"""
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import example_numbers as numbers
from torch_parity import reference_example

from repro_torch.examples import overlap_training, train_dp_occl

# `PYTHONPATH=src python examples/overlap_training.py` (JAX 0.9 on the CPU)
# prints these ledgers (supersteps, hidden, exposed) before it raises at
# examples/overlap_training.py:116.
OVERLAP_REFERENCE = {
    "dense": {"buckets": 7, "n_ranks": 2,
              "barrier": {"supersteps": 162, "hidden": 0, "exposed": 162},
              "overlapped": {"supersteps": 185, "hidden": 112,
                             "exposed": 73}},
    "moe": {"barrier": {"supersteps": 360, "hidden": 0, "exposed": 360},
            "overlapped": {"supersteps": 320, "hidden": 64,
                           "exposed": 256}}}


def test_overlap_training():
    res = overlap_training.main(["--device", "cpu"])
    moe = dict(res["moe"])
    # the example itself holds the output within OVERLAP_CLOSE
    assert moe.pop("overlap_max_abs_diff") <= 1e-9
    assert {"dense": res["dense"], "moe": moe} == OVERLAP_REFERENCE
    assert res["fabric"]["supersteps"] == 162 + 185 + 360 + 320


def test_train_dp_occl_tiny():
    args = ("--steps", "12", "--tiny")
    with reference_example("train_dp_occl", *args) as output:
        res = train_dp_occl.main(["--device", "cpu", *args])
        ref = output()
    ft = res["ft"]
    assert [len(ft["steps"]), ft["restarts"]] == numbers(
        r"\[ft loop\] (\d+) steps, (\d+) recovery", ref) == [18, 1]
    # a failure before step 6, recovered from the step-0 checkpoint
    assert ft["steps"] == list(range(6)) + list(range(12))
    assert ft["losses"][6] == ft["losses"][0]
    dp = res["dp_loop"]
    assert [dp["steps"], dp["buckets"], dp["supersteps"]] == numbers(
        r"\[occl dp\] (\d+) steps in .*buckets=(\d+), daemon "
        r"supersteps=(\d+)", ref) == [12, 2, 2016]
    assert [res["dp"], res["leaves"]] == [2, 14]
