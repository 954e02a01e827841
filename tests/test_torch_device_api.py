"""The in-step tick and the device API of the port against the reference.

* ``encode_state`` / ``decode_state`` round-trip every leaf bit for bit
  and give the reference encoding's bit patterns.
* ``DeviceApi`` step prologue -> submits -> overlap ticks -> drain on a
  small R=4 runtime (a flat ring all-reduce and a two-level chain) leaves
  the port's state equal to the reference's leaf by leaf, after every
  tick, and reads equal outputs.
* The three tests of ``tests/test_overlap.py`` on the port: ``drive()``,
  ``drive(tick_k=1)`` and ``drive(tick_k=7)`` are bit-identical in outputs
  and trajectories, and equal to the reference's ``drive()``; the tick
  counters reconcile; conflicting chained orders complete through in-step
  ticks alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.state import DaemonState as JState
import repro_torch.core as T
from repro.core import device_api as jdapi
from repro_torch.core import device_api as tdapi
from torch_parity import bits, one_torch_thread, runtime  # noqa: F401

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

R = 4
TRAJ_KEYS = ("supersteps", "preempts", "stage_completions", "completed",
             "launch_steps", "stall_slices", "slices_moved", "tick_calls",
             "barrier_supersteps", "overlap_supersteps", "rtc_events")


def assert_state_equal(jst, tst, where="") -> None:
    """A reference DaemonState and a port one, leaf by leaf, bitwise."""
    tn = T.state_to_numpy(tst)
    for f in JState._fields:
        want = np.asarray(getattr(jst, f))
        got = tn[f]
        if want.dtype.kind == "f" or want.dtype.itemsize == 2:
            want, got = bits(want), bits(got)
        np.testing.assert_array_equal(got, want, err_msg=f"{where} {f}")


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_decode_roundtrip_and_reference_bits(dtype):
    cfg = dict(n_ranks=R, max_colls=4, max_comms=1, slice_elems=8,
               conn_depth=4, heap_elems=1 << 10, dtype=dtype)
    jrt = runtime(J, **cfg)
    rng = np.random.RandomState(5)
    jst = jrt.state
    # Fill every leaf with seeded values of its dtype (bools included).
    leaves = {}
    for f in JState._fields:
        a = np.asarray(getattr(jst, f))
        if a.dtype == np.bool_:
            leaves[f] = rng.rand(*a.shape) < 0.5
        elif a.dtype == np.int32:
            leaves[f] = rng.randint(-2**31, 2**31 - 1, a.shape,
                                    dtype=np.int64).astype(np.int32)
        else:
            leaves[f] = rng.randn(*a.shape).astype(np.float32)
    jst = JState(**{
        f: jnp.asarray(v, getattr(jst, f).dtype) for f, v in leaves.items()})
    tcfg = T.OcclConfig(**cfg)
    tst = T.state_from_numpy({f: np.asarray(getattr(jst, f))
                              for f in JState._fields}, tcfg, "cpu")
    tenc = tdapi.encode_state(tst)
    jenc = jdapi.encode_state(jst)
    for f, a, b in zip(JState._fields, jenc, tenc):
        assert b.dtype == torch.float32, f
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a).view(np.uint32),
                                      err_msg=f)
    assert_state_equal(jst, tdapi.decode_state(tenc, tst), "roundtrip")
    zeros = tdapi.encoded_zeros(tst)
    assert all(z.dtype == torch.float32 and not z.any() for z in zeros)


# ---------------------------------------------------------------------------
# DeviceApi leaf by leaf
# ---------------------------------------------------------------------------

def api_runtime(core):
    rt = runtime(core, n_ranks=R, max_colls=8, max_comms=3, slice_elems=4,
                 conn_depth=4, heap_elems=1 << 12,
                 order_policy=core.OrderPolicy.PRIORITY,
                 superstep_budget=1 << 12, quit_threshold=64)
    comm = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=24),
           rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=20,
                       algo="two_level", hierarchy=(2, 2))]
    return rt, ids


@pytest.mark.parametrize("k", [2, 5])
def test_device_api_matches_reference_leaf_by_leaf(k):
    jrt, jids = api_runtime(J)
    trt, tids = api_runtime(T)
    assert jids == tids
    japi, tapi = jrt.device_api(), trt.device_api()
    rng = np.random.RandomState(k)
    xs = rng.randn(2, R, 24).astype(np.float32)
    xs[1, :, 20:] = 0
    jst = japi.step_prologue(jrt.state)
    tst = tapi.step_prologue(trt.state, ticks=(k,))
    assert_state_equal(jst, tst, "prologue")
    jtick = jax.jit(lambda s: japi.tick(s, jnp.int32(k), barrier=False))
    for r in range(R):
        for slot in ((0, 1) if r % 2 else (1, 0)):
            n = 24 if slot == 0 else 20
            jst = japi.submit(jst, r, jids[slot], jnp.asarray(xs[slot, r, :n]),
                              prio=slot)
            tst = tapi.submit(tst, r, tids[slot],
                              torch.from_numpy(xs[slot, r, :n]), prio=slot)
            assert_state_equal(jst, tst, f"submit {r} {slot}")
            jst, jf = jtick(jst)
            tst, tf = tapi.tick(tst, k, barrier=False)
            assert_state_equal(jst, tst, f"tick {r} {slot}")
            assert int(tf.steps) == int(jf.steps)
            assert bool(tf.live) == bool(jf.live)
            assert bool(tf.drained) == bool(jf.drained)
    jst = jax.jit(japi.drain)(jst)
    tst = tapi.drain(tst)
    assert_state_equal(jst, tst, "drain")
    for slot, cid in enumerate(tids):
        got = tapi.read_all(tst, cid).numpy()
        np.testing.assert_array_equal(
            bits(got), bits(np.asarray(japi.read_all(jst, jids[slot]))))
        np.testing.assert_allclose(got[0], xs[slot, :, :got.shape[1]].sum(0),
                                   rtol=1e-5, atol=1e-5)
        assert (tapi.completed(tst, cid).numpy() >= 1).all()
        np.testing.assert_array_equal(tapi.read(tst, 2, cid).numpy(), got[2])
    trt.adopt_state(tst)
    jrt.adopt_state(jst)
    st = trt.stats()
    np.testing.assert_array_equal(
        st["overlap_supersteps"] + st["barrier_supersteps"],
        st["supersteps"])
    assert int(st["overlap_supersteps"].max()) > 0


# ---------------------------------------------------------------------------
# tests/test_overlap.py on the port
# ---------------------------------------------------------------------------

def _mixed_runtime(core):
    """Every collective kind plus a chained two-level composite and a
    ragged a2a, submitted in conflicting per-rank orders."""
    rt = runtime(core, n_ranks=R, max_colls=12, max_comms=3, slice_elems=4,
                 conn_depth=4, heap_elems=1 << 15,
                 order_policy=core.OrderPolicy.FIFO,
                 superstep_budget=1 << 14, quit_threshold=64)
    comm = rt.communicator(list(range(R)))
    rng = np.random.RandomState(11)
    K = core.CollKind
    specs = [
        (K.ALL_REDUCE, dict(n_elems=24)),
        (K.ALL_GATHER, dict(n_elems=16)),
        (K.REDUCE_SCATTER, dict(n_elems=16)),
        (K.BROADCAST, dict(n_elems=12, root=1)),
        (K.REDUCE, dict(n_elems=12, root=2)),
        (K.ALL_TO_ALL, dict(n_elems=16)),
        (K.ALL_TO_ALL_RAGGED, dict(n_elems=12, chunk_sizes=(2, 1, 0, 3))),
        (K.ALL_REDUCE, dict(n_elems=20, algo="two_level",
                            hierarchy=(2, 2))),
    ]
    ids = [rt.register(kind, comm, **kw) for kind, kw in specs]
    for r in range(R):
        for slot in np.roll(np.arange(len(ids)), r):
            kind, kw = specs[slot]
            if kind == K.ALL_GATHER:
                data = rng.randn(kw["n_elems"] // R)
            elif kind == K.ALL_TO_ALL_RAGGED:
                data = rng.randn(sum(kw["chunk_sizes"]))
            elif kind == K.BROADCAST and r != kw["root"]:
                rt.submit(r, ids[slot])
                continue
            else:
                data = rng.randn(kw["n_elems"])
            rt.submit(r, ids[slot], data=data.astype(np.float32))
    return rt, ids


def _run_mode(core, tick_k):
    rt, ids = _mixed_runtime(core)
    rt.drive(max_launches=8, tick_k=tick_k)
    outs = {(r, cid): np.asarray(rt.read_output(r, cid))
            for cid in ids for r in range(R)}
    st = rt.stats()
    return outs, {k: np.asarray(st[k]).copy() for k in TRAJ_KEYS}, st


@pytest.fixture(scope="module")
def reference_drive():
    return _run_mode(J, None)


@pytest.mark.parametrize("tick_k", [None, 1, 7])
def test_tick_mode_bit_identical_to_drive(reference_drive, tick_k):
    """Outputs AND trajectory: batching ticks must be unobservable, and the
    port's trajectory is the reference's.  ``tick_calls`` counts the
    calls, so it is held only for the one-shot launch."""
    outs0, traj0, _ = reference_drive
    outs, traj, _ = _run_mode(T, tick_k)
    assert outs.keys() == outs0.keys()
    for key in outs0:
        np.testing.assert_array_equal(bits(outs[key]), bits(outs0[key]),
                                      err_msg=str(key))
    for k in TRAJ_KEYS:
        if k == "tick_calls" and tick_k is not None:
            continue
        np.testing.assert_array_equal(traj[k], traj0[k], err_msg=k)


def test_counters_reconcile_with_stage_completions():
    """overlap + barrier == supersteps; rtc_events == stage_completions;
    drive() is all-barrier."""
    _, _, st = _run_mode(T, 7)
    np.testing.assert_array_equal(
        st["overlap_supersteps"] + st["barrier_supersteps"],
        st["supersteps"])
    np.testing.assert_array_equal(st["rtc_events"], st["stage_completions"])
    assert int(st["tick_calls"].max()) >= 1
    done = st["rtc_events"] > 0
    assert np.all(st["rtc_latency"][done] > 0)
    assert int(st["overlap_supersteps"].max()) == 0


def test_in_step_ticks_survive_conflicting_chained_orders():
    """Two device-chained two-level all-reduces submitted in opposite
    per-rank orders entirely through DeviceApi submits + bounded overlap
    ticks, then a drain: the static baseline wedges on these orders; the
    port completes them with correct sums, in the reference's supersteps."""
    orders = {0: [0, 1], 1: [1, 0], 2: [0, 1], 3: [1, 0]}
    static = T.run_static_order(orders, {0: list(range(R)),
                                         1: list(range(R))})
    assert static.deadlocked and static.cycle
    rng = np.random.RandomState(3)
    xs = rng.randn(2, R, 16).astype(np.float32)
    res = {}
    for core in (J, T):
        rt = runtime(core, n_ranks=R, max_colls=8, max_comms=3,
                     slice_elems=4, conn_depth=3, heap_elems=1 << 14,
                     order_policy=core.OrderPolicy.FIFO,
                     superstep_budget=1 << 14, quit_threshold=64)
        comm = rt.communicator(list(range(R)))
        ids = [rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=16,
                           algo="two_level", hierarchy=(2, 2))
               for _ in range(2)]
        api = rt.device_api()
        if core is J:
            @jax.jit
            def step(st, payloads):
                st = api.step_prologue(st)
                for r in range(R):
                    for slot in orders[r]:
                        st = api.submit(st, r, ids[slot], payloads[slot, r],
                                        prio=slot)
                        st, _ = api.tick(st, jnp.int32(3), barrier=False)
                st = api.drain(st)
                return st, jnp.stack([api.read_all(st, c) for c in ids])

            st, outs = step(rt.state, jnp.asarray(xs))
            outs = np.asarray(outs)
        else:
            st = api.step_prologue(rt.state, ticks=(3, 16))
            for r in range(R):
                for slot in orders[r]:
                    st = api.submit(st, r, ids[slot],
                                    torch.from_numpy(xs[slot, r]), prio=slot)
                    st, _ = api.tick(st, 3, barrier=False)
            st = api.drain(st)
            outs = torch.stack([api.read_all(st, c) for c in ids]).numpy()
            for cid in ids:
                assert (api.completed(st, cid).numpy() >= 1).all()
        rt.adopt_state(st)
        res[core] = (outs, rt.stats())
    outs, stats = res[T]
    for slot in range(2):
        for r in range(R):
            np.testing.assert_allclose(outs[slot, r], xs[slot].sum(axis=0),
                                       rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(bits(outs), bits(res[J][0]))
    for k in TRAJ_KEYS:
        np.testing.assert_array_equal(stats[k], np.asarray(res[J][1][k]),
                                      err_msg=k)
    np.testing.assert_array_equal(
        stats["overlap_supersteps"] + stats["barrier_supersteps"],
        stats["supersteps"])
    assert int(stats["overlap_supersteps"].max()) > 0


def test_device_api_goes_stale_after_evict():
    """tests/test_reliability.py's staleness test on the port: an api kept
    across ``evict`` refuses to open a step; a fresh one binds the shrunk
    runtime and runs."""
    rt = runtime(T, n_ranks=R, max_colls=4, max_comms=1, slice_elems=4,
                 conn_depth=4, heap_elems=1 << 10)
    h = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(range(R)),
                    n_elems=16)
    rng = np.random.RandomState(0)
    h.submit_all(data={r: rng.randn(16).astype(np.float32)
                       for r in range(R)})
    rt.drive()
    api = rt.device_api()
    assert not api.stale
    rt.evict(0)
    assert api.stale
    with pytest.raises(T.EvictionError):
        api.step_prologue(rt.state)
    api2 = rt.device_api()
    assert not api2.stale and api2 is not api
    xs = rng.randn(R - 1, 16).astype(np.float32)
    st = api2.step_prologue(rt.state)
    st = api2.submit_all(st, int(h), torch.from_numpy(xs))
    st = api2.drain(st)
    rt.adopt_state(st)
    np.testing.assert_allclose(api2.read_all(st, int(h)).numpy(),
                               np.broadcast_to(xs.sum(0), xs.shape),
                               rtol=1e-5, atol=1e-5)
