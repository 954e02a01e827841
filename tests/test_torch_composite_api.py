"""Composite registration's API on the port against the JAX reference:
``tests/test_composite.py``'s routing, repeat-submission, auto-selection,
offset-override, priority, ``submit_all``, bandwidth-skew and
``logical_communicator`` cases, each run on both packages with outputs and
counters held bitwise equal.
"""
import numpy as np
import pytest

from torch_parity import run_both, runtime
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _rt(core, R, max_colls=16, max_comms=4, **kw):
    rt = runtime(core, n_ranks=R, max_colls=max_colls, max_comms=max_comms,
                 slice_elems=8, conn_depth=kw.pop("conn_depth", 6),
                 heap_elems=kw.pop("heap_elems", 1 << 15),
                 superstep_budget=1 << 14, **kw)
    return rt, rt.communicator(list(range(R)))


def logical_communicator(core):
    """A logical_communicator() descriptor registers composites without
    spending a lane; flat registration on it is rejected."""
    rt = runtime(core, n_ranks=8, max_colls=8, max_comms=2, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15, superstep_budget=1 << 14)
    grid = rt.logical_communicator(range(8))
    cid = rt.register(core.CollKind.ALL_REDUCE, grid, n_elems=48,
                      algo="two_level", hierarchy=(2, 4))
    assert len(rt.comms) == 2
    with pytest.raises(ValueError, match="lane-bound"):
        rt.register(core.CollKind.ALL_REDUCE, grid, n_elems=8)
    xs = [np.full(48, r + 1.0, np.float32) for r in range(8)]
    for r in range(8):
        rt.submit(r, cid, data=xs[r])
    rt.drive()
    outs = {r: rt.read_output(r, cid) for r in range(8)}
    for r in range(8):
        np.testing.assert_allclose(outs[r], np.sum(xs, axis=0), rtol=1e-5)
    return rt, outs


def partial_membership(core):
    """Tree-reduce non-leaders run only the intra stage: their CQE fires at
    the head; callbacks surface the logical id once per rank."""
    R, n = 8, 24
    rt, world = _rt(core, R, max_comms=6)
    cid = rt.register(core.CollKind.REDUCE, world, n_elems=n, root=0,
                      algo="tree", hierarchy=(2, 4))
    chain = rt._chain_of[cid]
    head, tail = chain[0], chain[-1]
    leaders = set(rt.specs[tail].comm.members)
    assert cid not in rt._entry_of
    assert set(rt._rank_tail[cid]) == set(range(R)) - leaders
    fired = []
    xs = [np.full(n, float(r + 1), np.float32) for r in range(R)]
    rt.submit_all(cid, data={r: xs[r] for r in range(R)},
                  callback=lambda rk, c: fired.append((rk, c)))
    rt.drive()
    assert sorted(fired) == [(r, cid) for r in range(R)]
    comp = rt.stats()["completed"]
    for r in range(R):
        assert comp[r, tail if r in leaders else head] == 1
    outs = {0: rt.read_output(0, cid)}
    np.testing.assert_allclose(outs[0], np.sum(xs, axis=0), rtol=1e-5)
    return rt, outs


def repeat_submissions(core):
    """A re-submitted chain head waits for the whole previous chain."""
    R, n = 4, 24
    rt, world = _rt(core, R)
    cid = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                      algo="two_level", hierarchy=(2, 2))
    rng = np.random.RandomState(7)
    xs1 = [rng.randn(n).astype(np.float32) for _ in range(R)]
    xs2 = [rng.randn(n).astype(np.float32) for _ in range(R)]
    done = []
    for r in range(R):
        rt.submit(r, cid, data=xs1[r], callback=lambda rk, c: done.append(1))
        rt.submit(r, cid, data=xs2[r], callback=lambda rk, c: done.append(2))
    rt.drive()
    assert len(done) == 2 * R
    st = rt.stats()
    chain = st["chains"][cid]
    assert (st["completed"][:, chain[-1]] == 2).all()
    assert (st["stage_completions"][:, chain] == 2).all()
    outs = {r: rt.read_output(r, cid) for r in range(R)}
    for r in range(R):
        np.testing.assert_allclose(outs[r], np.sum(xs2, axis=0), rtol=1e-4,
                                   atol=1e-5)
    return rt, outs


def auto_selection(core):
    """auto under one explicit cost model: the flat ring below the
    crossover, a chained plan above it under bandwidth skew."""
    rt, world = _rt(core, 8, max_comms=8, heap_elems=1 << 16,
                    burst_slices=8, conn_depth=24, bandwidth_groups=2,
                    inter_burst_cap=1)
    rt._cost_model = core.CostModel.default()
    small = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=64,
                        algo="auto")
    big = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=4096,
                      algo="auto")
    assert small not in rt._chain_of and big in rt._chain_of
    rng = np.random.RandomState(0)
    data = {c: [rng.randn(n).astype(np.float32) for _ in range(8)]
            for c, n in [(small, 64), (big, 4096)]}
    for r in range(8):
        rt.submit(r, big, data=data[big][r])
        rt.submit(r, small, data=data[small][r])
    rt.drive()
    outs = {}
    for c in (small, big):
        for r in range(8):
            outs[(r, int(c))] = rt.read_output(r, c)
            np.testing.assert_allclose(outs[(r, int(c))],
                                       np.sum(data[c], axis=0), rtol=1e-4,
                                       atol=1e-4)
    return rt, outs


def offset_overrides(core):
    """in_off lands on the chain head's read, out_off on the tail's
    write."""
    R, n = 4, 32
    rt, world = _rt(core, R)
    cid = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                      algo="two_level", hierarchy=(2, 2))
    alt_in, alt_out = 1 << 12, (1 << 12) + 512
    rng = np.random.RandomState(1)
    xs = [rng.randn(n).astype(np.float32) for _ in range(R)]
    for r in range(R):
        rt.submit(r, cid, data=xs[r], in_off=alt_in, out_off=alt_out)
    rt.drive()
    outs = {r: rt.read_output(r, cid, out_off=alt_out) for r in range(R)}
    for r in range(R):
        np.testing.assert_allclose(outs[r], np.sum(xs, axis=0), rtol=1e-4,
                                   atol=1e-5)
    assert not np.allclose(rt.read_output(0, cid), np.sum(xs, axis=0))
    with pytest.raises(ValueError, match="out_off"):
        rt.submit(0, cid, out_off=rt.cfg.heap_elems)
    return rt, outs


def priority_inherit(core):
    """A high-priority chain passes its priority to its device-enqueued
    stages."""
    R, n = 4, 64
    rt, world = _rt(core, R, order_policy=core.OrderPolicy.PRIORITY)
    lo = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)
    hi = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                     algo="two_level", hierarchy=(2, 2))
    rng = np.random.RandomState(2)
    xs = {c: [rng.randn(n).astype(np.float32) for _ in range(R)]
          for c in (lo, hi)}
    for r in range(R):
        rt.submit(r, lo, prio=0, data=xs[lo][r])
        rt.submit(r, hi, prio=7, data=xs[hi][r])
    rt.drive()
    chain = rt.stats()["chains"][hi]
    assert (np.asarray(rt.state.prio)[:, chain[1:]] == 7).all()
    outs = {(r, int(c)): rt.read_output(r, c) for c in (lo, hi)
            for r in range(R)}
    return rt, outs


def submit_all_per_rank(core):
    R, n = 4, 16
    rt, world = _rt(core, R, order_policy=core.OrderPolicy.PRIORITY)
    cid = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)
    rng = np.random.RandomState(3)
    xs = {r: rng.randn(n).astype(np.float32) for r in range(R)}
    seen = []
    rt.submit_all(cid, prio={r: r for r in range(R)}, data=xs,
                  callback={0: lambda rk, c: seen.append((rk, c))},
                  out_off={1: 1 << 12})
    rt.drive()
    assert seen == [(0, cid)]
    outs = {0: rt.read_output(0, cid),
            1: rt.read_output(1, cid, out_off=1 << 12)}
    for r in outs:
        np.testing.assert_allclose(outs[r], np.sum(list(xs.values()),
                                                   axis=0), rtol=1e-5)
    return rt, outs


def bandwidth_skew(core):
    """Derived intra lanes keep the full burst, island-crossing lanes get
    the inter cap."""
    R, n = 8, 48
    rt, world = _rt(core, R, max_comms=6, burst_slices=8, conn_depth=24,
                    bandwidth_groups=2, inter_burst_cap=2)
    cid = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                      algo="two_level", hierarchy=(2, 4))
    xs = [np.full(n, r + 1.0, np.float32) for r in range(R)]
    rt.submit_all(cid, data={r: xs[r] for r in range(R)})
    rt.drive()
    caps = rt.stats()["lane_caps"]
    intra = rt.specs[rt._chain_of[cid][0]].comm.lane
    inter = rt.specs[rt._chain_of[cid][1]].comm.lane
    assert (caps[0], caps[intra], caps[inter]) == (2, 8, 2)
    outs = {r: rt.read_output(r, cid) for r in range(R)}
    for r in range(R):
        np.testing.assert_allclose(outs[r], np.sum(xs, axis=0), rtol=1e-5)
    return rt, outs


@pytest.mark.parametrize("scenario", [
    logical_communicator, partial_membership, repeat_submissions,
    auto_selection, offset_overrides, priority_inherit, submit_all_per_rank,
    bandwidth_skew], ids=lambda f: f.__name__)
def test_composite_api_matches_reference(scenario):
    run_both(scenario)
