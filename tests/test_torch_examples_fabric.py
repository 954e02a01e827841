"""The port's flat-ring examples (``repro_torch.examples``: quickstart,
adversarial_orders, elastic_shrink) against the reference's scripts
(``examples/*.py``) on the CPU.

Each test runs the reference's script in a subprocess (JAX on the CPU)
while the port's ``main(["--device", "cpu"])`` runs here, then holds the
port's printed lines to the script's, line for line (none of these
examples prints a time), and the port's returned counts to the numbers the
script printed (``test_torch_examples_composite.py``,
``test_torch_examples_moe.py`` and ``test_torch_examples_train.py`` do the
same for the other five).
"""
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import example_numbers as numbers
from torch_parity import run_against_reference


def test_quickstart(capsys):
    res, ref = run_against_reference("quickstart", capsys)
    got = [res[k] for k in ("completed", "n_ranks", "supersteps",
                            "preempts")]
    assert got == numbers(r"completed (\d+) collective executions on (\d+) "
                          r"ranks in (\d+) supersteps \((\d+) preemptions",
                          ref) == [8, 4, 116, 12]
    assert res["fabric"] == {"supersteps": 116, "preempts": 12}


def test_adversarial_orders(capsys):
    res, ref = run_against_reference("adversarial_orders", capsys)
    assert res["static"] == {"deadlocked": True, "completed": [],
                             "cycle": [0, 1]}
    got = [res[k] for k in ("completed", "preempts", "launches")]
    assert got == numbers(r"OCCL: (\d+) collective executions, (\d+) "
                          r"preemptions \(context switches\), (\d+) daemon "
                          r"launches", ref) == [192, 606, 3]
    # chip_smoke.py phase 4a holds the card to the same superstep count
    assert res["supersteps"] == 3486


def test_elastic_shrink(capsys):
    res, ref = run_against_reference("elastic_shrink", capsys)
    assert res["holders"] == [5]
    assert "28 collectives outstanding after 4 consecutive daemon " \
           "launches without progress (5 total)" in res["timeout"]
    assert res["tail"] == "PREEMPT(coll=3), PREEMPT(coll=0), " \
                          "PREEMPT(coll=1)"
    ev = res["evict"]
    assert [ev["n_ranks"], ev["replayed"], ev["dropped"],
            ev["generation"]] == numbers(
        r"now R=(\d+), replayed (\d+) staged submissions, dropped (\d+) "
        r"from the dead rank \(generation (\d+)\)", ref) == [7, 28, 0, 1]
    assert [res["supersteps"], res["fresh_supersteps"]] == numbers(
        r"\((\d+) vs (\d+) supersteps\)", ref) == [156, 156]
