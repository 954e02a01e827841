"""Composite collectives on the port, held to the JAX reference: the plan
zoo, ``select_algo`` / the cost model, registration and its chain tables
(``tests/test_composite.py``'s planning, selection and registration cases,
each as a parity test), plus the chain advancing in one launch and
conflicting chained orders completing, bit for bit against the reference.

The end-to-end numeric cases of ``tests/test_composite.py`` are ported in
``test_torch_composite_runs.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.tables import build_tables as j_build_tables
from repro_torch.core.tables import build_tables as t_build_tables
from torch_parity import assert_tables_equal, run_both, runtime
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

GRIDS = {4: [(2, 2)], 8: [(2, 4), (4, 2)], 16: [(4, 4), (2, 8), (8, 2)]}
PLANS = [("two_level", "ALL_REDUCE"), ("torus", "ALL_REDUCE"),
         ("hybrid", "ALL_REDUCE"), ("tree", "BROADCAST"), ("tree", "REDUCE"),
         ("two_level", "ALL_TO_ALL")]


# ---------------------------------------------------------------------------
# planning / selection units
# ---------------------------------------------------------------------------

def test_default_hierarchy_most_square():
    for R in range(1, 33):
        assert T.default_hierarchy(R) == J.default_hierarchy(R)
    assert T.default_hierarchy(16) == (4, 4)
    assert T.default_hierarchy(7) == (7, 1)       # prime: degenerate


def _plan_fields(plan):
    return (int(plan.kind), plan.n_elems, plan.hierarchy,
            [dataclasses.astuple(s) for s in plan.stages])


@pytest.mark.parametrize("algo,kind", PLANS)
def test_plans_equal_reference(algo, kind):
    """Every plan of the zoo, over every grid of R in {4, 8, 16}, every
    root and two payload sizes, stage for stage."""
    n_cases = 0
    for R, grids in GRIDS.items():
        for hier in grids:
            for root in range(R):
                for n in (R * 4, R * 13):
                    j = J.build_plan(algo, J.CollKind[kind], range(R), hier,
                                     n, root)
                    t = T.build_plan(algo, T.CollKind[kind], range(R), hier,
                                     n, root)
                    assert _plan_fields(t) == _plan_fields(j)
                    n_cases += 1
    assert n_cases > 100


def test_plan_two_level_rejects_bad_grids():
    for core in (J, T):
        with pytest.raises(ValueError, match="does not tile"):
            core.plan_two_level(core.CollKind.ALL_REDUCE, range(8), (3, 2),
                                10)
        with pytest.raises(ValueError, match="ALL_REDUCE only"):
            core.plan_two_level(core.CollKind.BROADCAST, range(8), (2, 4),
                                10)


def test_plan_registry_contents():
    assert sorted((a, int(k)) for a, k in T.PLAN_BUILDERS) == \
        sorted((a, int(k)) for a, k in J.PLAN_BUILDERS)
    assert {int(k): v for k, v in T.AUTO_CANDIDATES.items()} == \
        {int(k): v for k, v in J.AUTO_CANDIDATES.items()}
    for kind, cands in T.AUTO_CANDIDATES.items():
        assert cands[0] == "ring"
        for a in cands[1:]:
            assert (a, kind) in T.PLAN_BUILDERS


MODELS = [(1.0, 0.0, 24.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0),
          (0.00054, 0.0, 0.0), (1e-3, 2e-9, 5e-3)]


@pytest.mark.parametrize("model", MODELS)
def test_select_algo_same_model_same_pick(model):
    """The same explicit CostModel passed to both packages picks the same
    algorithm, and the two packages' plan features are equal, over kinds,
    sizes, grids and bandwidth-skew configs."""
    jm, tm = J.CostModel(*model), T.CostModel(*model)
    picks = set()
    for skew in ({}, dict(bandwidth_groups=2, inter_burst_cap=2),
                 dict(bandwidth_groups=4, inter_burst_cap=1)):
        kw = dict(n_ranks=16, burst_slices=8, conn_depth=24, max_comms=8,
                  max_colls=8, **skew)
        jc, tc = J.OcclConfig(**kw), T.OcclConfig(**kw)
        for kind in ("ALL_REDUCE", "BROADCAST", "REDUCE", "ALL_TO_ALL",
                     "ALL_GATHER"):
            for n in (64, 256, 4096, 1 << 16):
                for hier in (None, (4, 4), (2, 8)):
                    j = J.select_algo("auto", J.CollKind[kind], n, 16, hier,
                                      jc, jm)
                    t = T.select_algo("auto", T.CollKind[kind], n, 16, hier,
                                      tc, tm)
                    assert t == j, (kind, n, hier, skew)
                    picks.add(t)
                    for a in T.AUTO_CANDIDATES[T.CollKind[kind]]:
                        try:
                            jf = J.plan_features(jc, J.CollKind[kind], n, 16,
                                                 hier, a)
                        except ValueError:
                            with pytest.raises(ValueError):
                                T.plan_features(tc, T.CollKind[kind], n, 16,
                                                hier, a)
                            continue
                        assert T.plan_features(tc, T.CollKind[kind], n, 16,
                                               hier, a) == jf
    assert picks                              # the sweep picked something


def test_select_algo_cost_model():
    """``tests/test_composite.py``'s selection rules on the port."""
    assert T.select_algo("ring", T.CollKind.ALL_REDUCE, 1 << 20, 16) == "ring"
    assert T.select_algo("torus", T.CollKind.ALL_REDUCE, 4, 16) == "torus"
    assert T.select_algo("auto", T.CollKind.ALL_REDUCE, 4096, 7) == "ring"
    assert T.select_algo("auto", T.CollKind.ALL_GATHER, 4096, 16) == "ring"
    stagey = T.CostModel(alpha=0.0, beta=0.0, gamma=1.0)
    assert T.select_algo("auto", T.CollKind.ALL_REDUCE, 1 << 20, 16,
                         model=stagey) == "ring"
    cfg = T.OcclConfig(n_ranks=16, burst_slices=8, conn_depth=24,
                       bandwidth_groups=4, inter_burst_cap=2, max_comms=8,
                       max_colls=8)
    lat = T.CostModel(alpha=1.0, beta=0.0, gamma=0.0)
    pick = T.select_algo("auto", T.CollKind.ALL_REDUCE, 1 << 16, 16,
                         cfg=cfg, model=lat)
    assert pick != "ring"
    with pytest.raises(ValueError, match="does not tile"):
        T.select_algo("auto", T.CollKind.ALL_REDUCE, 4096, 16, (4, 5))


def test_cost_model_fit_save_load_equal_reference(tmp_path, monkeypatch):
    """``fit`` on the same samples gives the reference's coefficients;
    ``save`` / ``load`` round-trip through the port's own file, and an
    absent file falls back to the default model."""
    from repro.core.costmodel import fit as jfit

    rng = np.random.RandomState(0)
    samples = []
    for i in range(12):
        s, b, g = rng.randint(10, 300), rng.randint(1e3, 1e6), \
            rng.randint(1, 5)
        samples.append({"supersteps": float(s), "bytes": float(b),
                        "stages": float(g), "tag": f"k/{i // 4}/{i % 4}",
                        "wall": 1e-3 * s + 1e-9 * b + 2e-3 * g})
    tm, jm = T.fit(samples), jfit(samples)
    assert (tm.alpha, tm.beta, tm.gamma) == (jm.alpha, jm.beta, jm.gamma)
    path = tmp_path / "calib.json"
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(path))
    assert T.CostModel.load() == T.CostModel.default()
    tm.save(extra={"card": "x"})
    got = T.CostModel.load()
    assert (got.alpha, got.beta, got.gamma) == (tm.alpha, tm.beta, tm.gamma)
    assert got.source == str(path)


# ---------------------------------------------------------------------------
# registration and chain tables
# ---------------------------------------------------------------------------

def _register(core, R, algo, kind, hier, root, n):
    cfg = core.OcclConfig(n_ranks=R, max_colls=16, max_comms=6,
                          slice_elems=8, conn_depth=6, heap_elems=1 << 16)
    rt = (core.OcclRuntime(cfg, device="cpu") if core is T
          else core.OcclRuntime(cfg))
    world = rt.communicator(list(range(R)))
    flat = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=24)
    head = rt.register(core.CollKind[kind], world, n_elems=n, root=root,
                       algo=algo, hierarchy=hier)
    tail = rt.register(core.CollKind.ALL_GATHER, world, n_elems=R * 5)
    return rt, (flat, head, tail)


@pytest.mark.parametrize("algo,kind", PLANS)
def test_registration_tables_equal_reference(algo, kind):
    """The gate of the chain tables: for every plan x kind x R in
    {4, 8, 16} x grid x root, the port's registration state and
    ``StaticTables`` (relink maps, per-rank chain maps included) equal the
    reference's field by field."""
    for R, grids in GRIDS.items():
        for hier in grids:
            roots = range(R) if kind in ("BROADCAST", "REDUCE") else [0]
            for root in roots:
                n = R * 6
                jrt, jids = _register(J, R, algo, kind, hier, root, n)
                trt, tids = _register(T, R, algo, kind, hier, root, n)
                assert [int(i) for i in tids] == [int(i) for i in jids]
                for f in ("_tail_of", "_chain_of", "_entry_of",
                          "_rank_tail", "_logical_members", "_algo_of"):
                    assert getattr(trt, f) == getattr(jrt, f), f
                assert [c.members for c in trt.comms] == \
                    [c.members for c in jrt.comms]
                jt = j_build_tables(jrt.cfg, jrt.comms, jrt.specs)
                tt = t_build_tables(trt.cfg, trt.comms, trt.specs)
                assert tt.has_chains
                assert_tables_equal(jt, tt)


def test_registration_chain_tables():
    rt = runtime(T, n_ranks=8, max_colls=16, max_comms=4, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15)
    world = rt.communicator(list(range(8)))
    flat = rt.register(T.CollKind.ALL_REDUCE, world, n_elems=32)
    head = rt.register(T.CollKind.ALL_REDUCE, world, n_elems=64,
                       algo="two_level", hierarchy=(2, 4))
    rt._ensure_built()
    t = rt._tables
    stages = rt.stats()["chains"][head]
    assert stages == [head, head + 1, head + 2]
    assert t.next_coll[flat] == -1 and t.chain_tail[flat] == flat
    assert list(t.next_coll[stages]) == [head + 1, head + 2, -1]
    assert list(t.chain_tail[stages]) == [head + 2] * 3
    for c, succ in zip(stages[:-1], stages[1:]):
        span = int(t.in_span[succ])
        np.testing.assert_array_equal(t.chain_dst[c, :span],
                                      t.base_in_off[succ] + np.arange(span))
        src = t.chain_src[c, :span]
        assert (src[t.stage_in_map[succ]] >= t.base_out_off[c]).all()
        pads = np.setdiff1d(np.arange(span), t.stage_in_map[succ])
        assert (src[pads] == -1).all()


@pytest.mark.parametrize("algo,kind", PLANS)
def test_relink_edges_equal_reference(algo, kind):
    """The daemon's static relink descriptors (slice or gather per edge)."""
    from repro.core.daemon import _relink_edges as jedges
    from repro_torch.core.daemon import _relink_edges as tedges

    jrt, _ = _register(J, 8, algo, kind, (2, 4), 5, 8 * 6)
    trt, _ = _register(T, 8, algo, kind, (2, 4), 5, 8 * 6)
    jt = j_build_tables(jrt.cfg, jrt.comms, jrt.specs)
    tt = t_build_tables(trt.cfg, trt.comms, trt.specs)
    assert tedges(tt) == jedges(jt) and tedges(tt)


def test_derived_communicators_share_lanes():
    rt = runtime(T, n_ranks=8, max_colls=16, max_comms=4, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15)
    world = rt.communicator(list(range(8)))
    a = rt.register(T.CollKind.ALL_REDUCE, world, n_elems=64,
                    algo="two_level", hierarchy=(2, 4))
    b = rt.register(T.CollKind.ALL_REDUCE, world, n_elems=48,
                    algo="two_level", hierarchy=(2, 4))
    lanes_a = {rt.specs[c].comm.lane for c in rt._chain_of[a]}
    lanes_b = {rt.specs[c].comm.lane for c in rt._chain_of[b]}
    assert lanes_a == lanes_b
    assert len(rt.comms) == 3


def test_lane_budget_validated():
    for core in (J, T):
        rt = runtime(core, n_ranks=8, max_colls=16, max_comms=2,
                     slice_elems=8, conn_depth=6, heap_elems=1 << 15)
        world = rt.communicator(list(range(8)))
        with pytest.raises(ValueError, match="max_comms"):
            rt.register(core.CollKind.ALL_REDUCE, world, n_elems=64,
                        algo="two_level", hierarchy=(2, 4))


# ---------------------------------------------------------------------------
# the chain on the device, against the reference
# ---------------------------------------------------------------------------

def chain_single_launch(core):
    R = 8
    rt = runtime(core, n_ranks=R, max_colls=16, max_comms=4, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15, superstep_budget=1 << 14)
    cid = rt.register(core.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                      n_elems=64, algo="two_level", hierarchy=(2, 4))
    xs = [np.full(64, r + 1, np.float32) for r in range(R)]
    for r in range(R):
        rt.submit(r, cid, data=xs[r])
    assert rt.launch_once() == R          # every logical CQE in launch 1
    assert rt.launches == 1 and rt.queues.outstanding() == 0
    st = rt.stats()
    chain = st["chains"][cid]
    assert (st["stage_completions"][:, chain] == 1).all()
    assert (st["completed"][:, chain[-1]] == 1).all()
    # Every stage but the tail handed off on the device.
    assert (st["flight_recorder"]["kind_counts"][:, 3] == 2).all()
    outs = {r: rt.read_output(r, cid) for r in range(R)}
    for r in range(R):
        np.testing.assert_allclose(outs[r], np.sum(xs, axis=0), rtol=1e-5)
    return rt, outs


def test_chain_advances_on_device_single_launch():
    run_both(chain_single_launch)


def mixed_conflicting_orders(core):
    """Two two-level chains on the same grid plus a flat all-reduce,
    submitted in pairwise-conflicting orders: the static single-FIFO
    baseline deadlocks; OCCL completes every chain."""
    R, n = 8, 48
    orders = {r: [0, 1, 2] if r % 2 == 0 else [2, 1, 0] for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in range(3)})
    assert static.deadlocked
    rt = runtime(core, n_ranks=R, max_colls=12, max_comms=3, slice_elems=8,
                 conn_depth=6, heap_elems=1 << 15, superstep_budget=1 << 14)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                       algo="two_level", hierarchy=(2, 4)),
           rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n,
                       algo="two_level", hierarchy=(2, 4)),
           rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)]
    rng = np.random.RandomState(5)
    xs = {c: [rng.randn(n).astype(np.float32) for _ in range(R)]
          for c in ids}
    for r in range(R):
        for slot in orders[r]:
            rt.submit(r, ids[slot], data=xs[ids[slot]][r])
    rt.drive(max_launches=128)
    outs = {}
    for c in ids:
        for r in range(R):
            outs[(r, int(c))] = rt.read_output(r, c)
            np.testing.assert_allclose(outs[(r, int(c))],
                                       np.sum(xs[c], axis=0),
                                       rtol=1e-4, atol=1e-5)
    assert rt.stats()["preempts"].sum() > 0
    return rt, outs


def test_mixed_chained_and_flat_conflicting_orders_complete():
    run_both(mixed_conflicting_orders)


def test_in_step_and_deferred_relink_agree():
    """The port has no ``cond_relink`` (a JAX tracing choice); its two
    relink placements must agree: the in-step scatter of ``lanes_step``
    and the deferred per-edge slices of the daemon body give the same
    state after every superstep of a chained run."""
    from repro_torch.core import daemon as D
    from repro_torch.core.scheduler import rank_superstep
    from repro_torch.core.state import state_to_numpy, tables_from_numpy

    rt = runtime(T, n_ranks=8, max_colls=8, max_comms=3, slice_elems=4,
                 conn_depth=5, heap_elems=1 << 12, burst_slices=2,
                 superstep_budget=1 << 12)
    cid = rt.register(T.CollKind.ALL_REDUCE,
                      rt.logical_communicator(range(8)), n_elems=40,
                      algo="two_level", hierarchy=(2, 4))
    rng = np.random.RandomState(1)
    for r in range(8):
        rt.submit(r, cid, data=rng.randn(40).astype(np.float32))
    rt._flush_staged()
    st0 = D.launch_prologue(rt.queues.pack_sq(rt.state))
    sh, lt, fwd, rev = tables_from_numpy(rt._tables, "cpu")
    body = D._sim_body_fn(rt.cfg, D._edge_plan(D._relink_edges(rt._tables),
                                               "cpu"))

    def clone(st):
        return type(st)(*[x.clone() for x in st])

    a, b = clone(st0), clone(st0)
    ia = ib = D._load_mailbox(st0)
    stages_done = 0
    for _ in range(40):
        a, ia = body(sh, lt, fwd, rev, a, ia)
        live = b.global_live
        nb, ob = rank_superstep(rt.cfg, sh, lt, b, ib, live=live)
        stages_done += int((nb.stage_completions
                            - b.stage_completions).sum())
        nb = nb._replace(global_live=a.global_live)
        b, ib = D._gate(live, nb, b), D._gate(live, D._sim_exchange(
            fwd, rev, ob), ib)
        sa, sb = state_to_numpy(a), state_to_numpy(b)
        for f in sa:
            np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    assert stages_done > 0
    assert torch.equal(a.heap_in, b.heap_in)
