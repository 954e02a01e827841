"""Composite collectives end to end on the port against the JAX reference:
``tests/test_composite.py``'s numeric cases — two_level, torus and hybrid
all-reduce and the tree broadcast and reduce, at R <= 8 over several grids,
roots and ragged sizes — as parity tests.  Outputs, ``supersteps``,
``preempts``, ``stall_slices``, ``stage_completions``, completions and the
flight recorder's per-kind counts must be bitwise equal, and the outputs
must match the numpy reference as the reference's own tests demand.
"""
import numpy as np
import pytest

from torch_parity import run_both, runtime
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def allreduce_plan(core, algo, R, hier, n):
    rt = runtime(core, n_ranks=R, max_colls=16, max_comms=6, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15, superstep_budget=1 << 14)
    cid = rt.register(core.CollKind.ALL_REDUCE,
                      rt.communicator(list(range(R))), n_elems=n, algo=algo,
                      hierarchy=hier)
    rng = np.random.RandomState(n + R)
    xs = [rng.randn(n).astype(np.float32) for _ in range(R)]
    rt.submit_all(cid, data={r: xs[r] for r in range(R)})
    rt.drive()
    outs = {r: rt.read_output(r, cid) for r in range(R)}
    for r in range(R):
        np.testing.assert_allclose(outs[r], np.sum(xs, axis=0), rtol=1e-4,
                                   atol=1e-5)
    assert len(rt.stats()["chains"][int(cid)]) == {
        "two_level": 3, "torus": 4, "hybrid": 3}[algo]
    return rt, outs


@pytest.mark.parametrize("R,hier,n", [(4, (2, 2), 40), (8, (2, 4), 100),
                                      (8, (4, 2), 8)])
def test_two_level_matches_reference(R, hier, n):
    run_both(allreduce_plan, "two_level", R, hier, n)


@pytest.mark.parametrize("algo", ["torus", "hybrid"])
@pytest.mark.parametrize("R,hier,n", [(8, (2, 4), 37), (8, (4, 2), 100)])
def test_new_allreduce_algos_match_reference(algo, R, hier, n):
    run_both(allreduce_plan, algo, R, hier, n)


def tree(core, kind, root, n):
    R, hier = 8, (2, 4)
    rt = runtime(core, n_ranks=R, max_colls=16, max_comms=6, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15, superstep_budget=1 << 14)
    cid = rt.register(core.CollKind[kind], rt.communicator(list(range(R))),
                      n_elems=n, root=root, algo="tree", hierarchy=hier)
    rng = np.random.RandomState(root + n)
    xs = [rng.randn(n).astype(np.float32) for _ in range(R)]
    rt.submit_all(cid, data={r: xs[r] for r in range(R)})
    rt.drive()
    if kind == "BROADCAST":
        outs = {r: rt.read_output(r, cid) for r in range(R)}
        for r in range(R):
            np.testing.assert_allclose(outs[r], xs[root], rtol=1e-5)
    else:
        outs = {root: rt.read_output(root, cid)}
        np.testing.assert_allclose(outs[root], np.sum(xs, axis=0),
                                   rtol=1e-4, atol=1e-5)
    return rt, outs


@pytest.mark.parametrize("root", [0, 7])
def test_tree_broadcast_matches_reference(root):
    run_both(tree, "BROADCAST", root, 37)


@pytest.mark.parametrize("root", [3])
def test_tree_reduce_matches_reference(root):
    run_both(tree, "REDUCE", root, 37)
