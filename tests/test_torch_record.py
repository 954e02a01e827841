"""The record's burst configuration on the port (R=8, n=8192, slice 64,
K=32, B=1, as ``benchmarks/bench_collectives.py`` ``_bench_one_kind``
runs it): the superstep count of the measured (second) iteration must equal
``BENCH_collectives.json`` ``bursts["1"]`` for all five collectives, and
outputs and counters must equal the reference runtime's bit for bit —
BROADCAST and REDUCE at root 0 and again at root 5."""
import json
import pathlib

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

R, N = 8, 8192
RECORD = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "BENCH_collectives.json").read_text())
KINDS = {"all_reduce": "ALL_REDUCE", "all_gather": "ALL_GATHER",
         "reduce_scatter": "REDUCE_SCATTER", "broadcast": "BROADCAST",
         "reduce": "REDUCE"}


def one_kind(core, kind_name, root=0):
    kind = core.CollKind[kind_name]
    cfg = core.OcclConfig(n_ranks=R, max_colls=2, max_comms=1,
                          slice_elems=64, conn_depth=32, burst_slices=1,
                          heap_elems=1 << 18, superstep_budget=1 << 15)
    rt = (core.OcclRuntime(cfg, device="cpu") if core is T
          else core.OcclRuntime(cfg))
    comm = rt.communicator(list(range(R)))
    cid = rt.register(kind, comm, n_elems=N, root=root)
    rng = np.random.RandomState(0)
    for r in range(R):
        n = -(-N // R) if kind == core.CollKind.ALL_GATHER else N
        data = rng.randn(n).astype(np.float32)
        if kind == core.CollKind.BROADCAST and r != root:
            continue
        rt.write_input(r, cid, data)

    def once():
        for r in range(R):
            rt.submit(r, cid)
        rt.drive()

    once()                                  # warm iteration
    s0 = int(rt.stats()["supersteps"].max())
    once()                                  # the measured iteration
    steps = int(rt.stats()["supersteps"].max()) - s0
    outs = {r: np.asarray(rt.read_output(r, cid)) for r in range(R)}
    return rt, steps, outs


@pytest.mark.parametrize("name,root", [(k, 0) for k in KINDS]
                         + [("broadcast", 5), ("reduce", 5)])
def test_record_superstep_counts_and_bitwise_parity(name, root):
    jrt, jsteps, jo = one_kind(J, KINDS[name], root)
    trt, tsteps, to = one_kind(T, KINDS[name], root)
    assert tsteps == jsteps
    if root == 0:
        want = RECORD["bursts"]["1"]["per_collective"][name]["supersteps"]
        assert tsteps == want, (name, tsteps, want)
    for r in range(R):
        np.testing.assert_array_equal(to[r].view(np.uint32),
                                      jo[r].view(np.uint32))
    js, ts = jrt.stats(), trt.stats()
    for k in ("supersteps", "preempts", "stall_slices", "stage_completions",
              "completed", "slices_moved"):
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=k)
    np.testing.assert_array_equal(ts["flight_recorder"]["kind_counts"],
                                  js["flight_recorder"]["kind_counts"])
