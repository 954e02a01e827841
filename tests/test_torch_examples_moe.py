"""The port's ``repro_torch.examples.moe_alltoall`` against the
reference's ``examples/moe_alltoall.py`` on the CPU, as
``test_torch_examples_fabric.py`` does: the printed lines line for line,
the returned counts against the script's numbers."""
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import example_numbers as numbers
from torch_parity import run_against_reference


def test_moe_alltoall(capsys):
    res, ref = run_against_reference("moe_alltoall", capsys)
    assert [res["program_len"], res["steps"]["ring"],
            res["steps"]["two_level"]] == numbers(
        r"program is (\d+) primitive steps, supersteps flat (\d+) vs "
        r"two-level (\d+)", ref) == [136, 136, 20]
    assert res["moe"] == {
        "no-drop": {"cap": 16, "bitwise": True},
        "capacity-dropped": {"cap": 4, "bitwise": True}}
    assert numbers(r"MoE no-drop \(E=(\d+), top_k=(\d+), cap=(\d+)\)",
                   ref) == [8, 2, 16]
    assert res["static"] == {"deadlocked": True, "cycle": [0, 1]}
    assert [res["preempts"], res["launches"]] == numbers(
        r"(\d+) preemptions, (\d+) daemon launches", ref) == [891, 1]
