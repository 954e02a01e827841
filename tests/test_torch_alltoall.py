"""ALL_TO_ALL on the port against the JAX reference: ``tests/test_alltoall.py``
case by case — program structure, the flat relay ring and its ragged
variant, the two-level composite (granule-transpose input permutations),
``algo="auto"``, registration validation and conflicting a2a orders — with
outputs and counters held bitwise equal to the reference's runs.
"""
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core.algos import build_ring_program as j_program
from repro.core.primitives import io_chunked as j_io, program_len as j_len
from repro_torch.core.algos import build_ring_program as t_program
from repro_torch.core.primitives import io_chunked as t_io
from repro_torch.core.primitives import program_len as t_len
from torch_parity import run_both, runtime
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _rt(core, R, max_colls=8, max_comms=4, heap_elems=1 << 16):
    rt = runtime(core, n_ranks=R, max_colls=max_colls, max_comms=max_comms,
                 slice_elems=8, conn_depth=8, heap_elems=heap_elems,
                 superstep_budget=1 << 15)
    return rt, rt.communicator(list(range(R)))


def _inputs(R, n, seed=0):
    """Per-rank payloads whose values encode (origin, position)."""
    rng = np.random.RandomState(seed)
    return [np.asarray(o * 1000 + rng.randn(n), np.float32)
            for o in range(R)]


def _a2a_ref(ins, R):
    c = ins[0].size // R
    return [np.concatenate([ins[o][m * c:(m + 1) * c] for o in range(R)])
            for m in range(R)]


# ---------------------------------------------------------------------------
# program structure
# ---------------------------------------------------------------------------

def test_program_len_and_programs_equal_reference():
    for R in range(1, 10):
        for kind in ("ALL_TO_ALL", "ALL_TO_ALL_RAGGED"):
            assert t_len(T.CollKind[kind], R) == j_len(J.CollKind[kind], R)
            assert t_io(T.CollKind[kind]) == j_io(J.CollKind[kind])
            for m in range(R):
                got = [(int(p), c) for p, c in
                       t_program(T.CollKind[kind], m, R)]
                want = [(int(p), c) for p, c in
                        j_program(J.CollKind[kind], m, R)]
                assert got == want
    # Distance-keyed ragged programs are rank-independent.
    progs = [t_program(T.CollKind.ALL_TO_ALL_RAGGED, m, 5) for m in range(5)]
    assert all(p == progs[0] for p in progs)


def test_unregistered_kind_lookups_name_the_registry():
    with pytest.raises(ValueError, match="registered kinds"):
        t_len(99, 4)
    with pytest.raises(ValueError, match="registered kinds"):
        t_io(99)
    with pytest.raises(ValueError, match="ALL_TO_ALL"):
        t_program(T.CollKind.ALL_TO_ALL, 0, 4, algo="nope")


# ---------------------------------------------------------------------------
# flat ring, ragged and two-level, end to end
# ---------------------------------------------------------------------------

def flat(core, R, n):
    rt, world = _rt(core, R)
    cid = rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n)
    xs = _inputs(R, n)
    for r in range(R):
        rt.submit(r, cid, data=xs[r])
    rt.drive()
    want = _a2a_ref(xs, R)
    outs = {m: rt.read_output(m, cid) for m in range(R)}
    for m in range(R):
        np.testing.assert_array_equal(outs[m], want[m])
    return rt, outs


@pytest.mark.parametrize("R,n", [(3, 12), (8, 64)])
def test_flat_ring_matches_reference(R, n):
    run_both(flat, R, n)


def ragged(core, R, sizes):
    n = R * max(sizes)
    rt, world = _rt(core, R)
    cid = rt.register(core.CollKind.ALL_TO_ALL_RAGGED, world, n_elems=n,
                      chunk_sizes=sizes)

    def seg(o, s):
        return np.asarray(o * 1000 + s * 10 + np.arange(sizes[s]),
                          np.float32)

    for r in range(R):
        rt.submit(r, cid, data=np.concatenate([seg(r, s) for s in range(R)]))
    rt.drive()
    outs = {m: rt.read_output(m, cid) for m in range(R)}
    for m in range(R):
        np.testing.assert_array_equal(
            outs[m], np.concatenate([seg((m - s) % R, s) for s in range(R)]))
    return rt, outs


@pytest.mark.parametrize("R,sizes", [(4, (3, 8, 0, 5)), (5, (4, 0, 0, 1, 3))])
def test_ragged_matches_reference(R, sizes):
    run_both(ragged, R, sizes)


def two_level_vs_flat(core, R, hier, n):
    rt, world = _rt(core, R, max_colls=12, heap_elems=1 << 17)
    fl = rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n)
    two = rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n,
                      algo="two_level", hierarchy=hier)
    xs = _inputs(R, n)
    for r in range(R):
        rt.submit(r, fl, data=xs[r])
        rt.submit(r, two, data=xs[r])
    rt.drive()
    want = _a2a_ref(xs, R)
    outs = {}
    for m in range(R):
        outs[(m, "flat")] = rt.read_output(m, fl)
        outs[(m, "two")] = rt.read_output(m, two)
        np.testing.assert_array_equal(outs[(m, "flat")], want[m])
        np.testing.assert_array_equal(outs[(m, "two")], want[m])
    return rt, outs


@pytest.mark.parametrize("R,hier,n", [(4, (2, 2), 16), (8, (4, 2), 64),
                                      (9, (3, 3), 36)])
def test_two_level_matches_flat(R, hier, n):
    run_both(two_level_vs_flat, R, hier, n)


def test_two_level_plan_validates():
    for core in (J, T):
        with pytest.raises(ValueError, match="divisible"):
            core.plan_two_level_alltoall(core.CollKind.ALL_TO_ALL, range(4),
                                         (2, 2), 10)
        with pytest.raises(ValueError, match="RAGGED"):
            core.plan_two_level_alltoall(core.CollKind.ALL_TO_ALL_RAGGED,
                                         range(4), (2, 2), 16)
        with pytest.raises(ValueError, match="does not tile"):
            core.plan_two_level_alltoall(core.CollKind.ALL_TO_ALL, range(8),
                                         (3, 2), 24)


def auto_a2a(core, model):
    rt, world = _rt(core, 8, max_colls=12, heap_elems=1 << 17)
    rt._cost_model = core.CostModel(*model)
    cid = rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=64,
                      algo="auto")
    xs = _inputs(8, 64)
    for r in range(8):
        rt.submit(r, cid, data=xs[r])
    rt.drive()
    want = _a2a_ref(xs, 8)
    outs = {m: rt.read_output(m, cid) for m in range(8)}
    for m in range(8):
        np.testing.assert_array_equal(outs[m], want[m])
    return rt, outs


def test_auto_resolves_and_runs():
    for model in ((1.0, 0.0, 24.0), (1.0, 0.0, 0.0)):
        jm, tm = J.CostModel(*model), T.CostModel(*model)
        for n in (60, 64, 4096):
            assert T.select_algo("auto", T.CollKind.ALL_TO_ALL, n, 8,
                                 model=tm) == \
                J.select_algo("auto", J.CollKind.ALL_TO_ALL, n, 8, model=jm)
    tm = T.CostModel(1.0, 0.0, 0.0)
    assert T.select_algo("auto", T.CollKind.ALL_TO_ALL, 60, 8,
                         model=tm) == "ring"            # indivisible
    assert T.select_algo("auto", T.CollKind.ALL_TO_ALL_RAGGED, 64, 8,
                         model=tm) == "ring"
    rt, _ = run_both(auto_a2a, (1.0, 0.0, 0.0))
    assert rt.stats()["algos"] == {0: "two_level"}


def test_registration_validates_contracts():
    for core in (J, T):
        rt, world = _rt(core, 4)
        with pytest.raises(ValueError, match="divisible"):
            rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=10)
        with pytest.raises(ValueError, match="ALL_TO_ALL_RAGGED"):
            rt.register(core.CollKind.ALL_REDUCE, world, n_elems=8,
                        chunk_sizes=(2, 2, 2, 2))
        with pytest.raises(ValueError, match="chunk_sizes"):
            rt.register(core.CollKind.ALL_TO_ALL_RAGGED, world, n_elems=8,
                        chunk_sizes=(2, 2))
        for sizes in ((9, 0, 0, 0), (0, 0, 0, 0)):
            with pytest.raises(ValueError):
                rt.register(core.CollKind.ALL_TO_ALL_RAGGED, world,
                            n_elems=8, chunk_sizes=sizes)
        with pytest.raises(ValueError, match="composite"):
            rt.register(core.CollKind.ALL_TO_ALL_RAGGED, world, n_elems=8,
                        chunk_sizes=(2, 1, 1, 2), algo="two_level",
                        hierarchy=(2, 2))


# ---------------------------------------------------------------------------
# deadlock scenarios on the new kind
# ---------------------------------------------------------------------------

def conflicting_a2a(core):
    R, n = 4, 16
    orders = {r: [0, 1] if r % 2 == 0 else [1, 0] for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in (0, 1)})
    assert static.deadlocked and static.cycle
    rt, world = _rt(core, R)
    ids = [rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n)
           for _ in range(2)]
    xs = {c: _inputs(R, n, seed=c) for c in (0, 1)}
    for r in range(R):
        for c in orders[r]:
            rt.submit(r, ids[c], data=xs[c][r])
    rt.drive()
    outs = {}
    for c in (0, 1):
        want = _a2a_ref(xs[c], R)
        for m in range(R):
            outs[(m, c)] = rt.read_output(m, ids[c])
            np.testing.assert_array_equal(outs[(m, c)], want[m])
    return rt, outs


def a2a_across_algorithms(core):
    """The MoE shape: a flat a2a, a two-level a2a and an all-reduce in
    rank-dependent conflicting orders."""
    R, n = 8, 32
    orders = {r: list(np.random.RandomState(r).permutation(3))
              for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in range(3)})
    assert static.deadlocked
    rt, world = _rt(core, R, max_colls=16, heap_elems=1 << 17)
    ids = [rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n),
           rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n,
                       algo="two_level", hierarchy=(2, 4)),
           rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)]
    xs = {c: _inputs(R, n, seed=10 + c) for c in range(3)}
    for r in range(R):
        for c in orders[r]:
            rt.submit(r, ids[c], data=xs[c][r])
    rt.drive()
    outs = {}
    for c in (0, 1):
        want = _a2a_ref(xs[c], R)
        for m in range(R):
            outs[(m, c)] = rt.read_output(m, ids[c])
            np.testing.assert_array_equal(outs[(m, c)], want[m])
    for m in range(R):
        outs[(m, 2)] = rt.read_output(m, ids[2])
        np.testing.assert_allclose(outs[(m, 2)], np.sum(xs[2], axis=0),
                                   rtol=1e-5)
    return rt, outs


@pytest.mark.parametrize("scenario", [conflicting_a2a,
                                      a2a_across_algorithms],
                         ids=lambda f: f.__name__)
def test_conflicting_a2a_orders_complete(scenario):
    run_both(scenario)
