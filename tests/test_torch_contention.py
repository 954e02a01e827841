"""The contention record on the port, as ``run_contention_sweep``
(``benchmarks/bench_collectives.py:540``) builds it: R=8, 8 adversarial
all-reduces of 2048 elements on one lane, slice 64, K=32, seed 42.  The
port must reproduce ``BENCH_collectives.json`` ``contention`` exactly —
1002 supersteps / 81 preempts / 4047 stall slices at B=1 and 334 / 150 /
6804 at B=8 — and match the reference runtime bit for bit."""
import json
import pathlib

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RECORD = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "BENCH_collectives.json").read_text())["contention"]


def contention(core, burst, n=2048, R=8, C=8, seed=42):
    rng = np.random.RandomState(seed)
    orders = {r: list(rng.permutation(C)) for r in range(R)}
    cfg = core.OcclConfig(n_ranks=R, max_colls=C, max_comms=1,
                          slice_elems=64, conn_depth=32, burst_slices=burst,
                          heap_elems=1 << 18, superstep_budget=1 << 15)
    rt = (core.OcclRuntime(cfg, device="cpu") if core is T
          else core.OcclRuntime(cfg))
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)
           for _ in range(C)]
    xs = {}
    for r in range(R):
        for slot in orders[r]:
            xs[(r, slot)] = rng.randn(n).astype(np.float32)
            rt.submit(r, ids[slot], data=xs[(r, slot)])
    rt.drive(max_launches=128)
    outs = {(r, i): np.asarray(rt.read_output(r, ids[i]))
            for r in range(R) for i in range(C)}
    for i in range(C):
        np.testing.assert_allclose(outs[(0, i)],
                                   sum(xs[(r, i)] for r in range(R)),
                                   rtol=1e-4, atol=1e-5)
    return rt, outs


@pytest.mark.parametrize("burst", [1, 8])
def test_contention_matches_record_and_reference(burst):
    trt, to = contention(T, burst)
    st = trt.stats()
    rec = RECORD["bursts"][str(burst)]
    assert int(st["supersteps"].max()) == rec["supersteps"]
    assert int(st["preempts"].sum()) == rec["preempts"]
    assert int(st["stall_slices"].sum()) == rec["stall_slices"]
    assert int(st["slices_moved"].sum()) == rec["slices"]
    jrt, jo = contention(J, burst)
    for k in jo:
        np.testing.assert_array_equal(to[k].view(np.uint32),
                                      jo[k].view(np.uint32), err_msg=str(k))
    js = jrt.stats()
    for k in ("supersteps", "preempts", "stall_slices", "stage_completions",
              "completed"):
        np.testing.assert_array_equal(st[k], np.asarray(js[k]), err_msg=k)
    for k in ("kind", "coll", "step", "count", "kind_counts"):
        np.testing.assert_array_equal(st["flight_recorder"][k],
                                      js["flight_recorder"][k], err_msg=k)
