"""The port's mesh backend (one device per rank) against the reference's
shard_map mesh and against the port's own sim.

The reference's mesh needs several XLA devices, so it runs ONCE per module
in a subprocess with 8 host devices (``XLA_FLAGS``), on a mesh built as
``jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rank",))``: its axis is
Auto.  (``jax.make_mesh`` gives an Explicit axis under JAX 0.9, on which the
reference's staging write raises.)  The port's mesh is 8 x ``cpu`` here.

The workloads are ``chip_smoke.py``'s phase 4d (the reference's own mesh
tests): outputs, the scheduler's counters and ``staging_sharded_flushes``
equal the reference's mesh bit for bit, and the port's mesh equals the
port's sim (which makes no sharded flush)."""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.daemon import (build_shardmap_daemon,
                                     build_shardmap_tick, launch_prologue)
from torch_parity import COUNTERS, one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = ["cpu"] * 8

pytestmark = pytest.mark.filterwarnings(
    "ignore::repro_torch.core.errors.ConnDepthWarning",
    "ignore::repro.core.errors.ConnDepthWarning")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def mesh_hang(core, make_rt):
    """Rank 5 never submits the all-reduce the other seven wait on."""
    rt = make_rt(dict(n_ranks=8, max_colls=4, max_comms=1, slice_elems=8,
                      conn_depth=4, heap_elems=1 << 12, quit_threshold=8))
    cid = rt.register(core.CollKind.ALL_REDUCE,
                      rt.communicator(list(range(8))), n_elems=32)
    for r in range(8):
        if r != 5:
            rt.submit(r, cid, data=np.full(32, float(r), np.float32))
    try:
        rt.drive(max_launches=3)
    except core.DeadlockTimeout as e:
        return rt, str(e), e.diagnosis.holders
    raise AssertionError("the hang did not raise DeadlockTimeout")


# The reference's run: every workload on its mesh, outputs as float32 and
# counters written to one npz, the hang's message and holders to json.
_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path[:0] = [@SRC@, @TESTS@, @ROOT@]
    import numpy as np, jax
    from jax.sharding import Mesh
    import repro.core as J
    import chip_smoke as cs
    import test_torch_mesh as tm

    mesh = Mesh(np.array(jax.devices()[:8]), ("rank",))
    make = lambda kw: J.OcclRuntime(J.OcclConfig(**kw), mesh=mesh)
    arrays = {}
    for name, fn in cs.MESH_WORKLOADS.items():
        rts, outs = fn(J, make)
        for k, v in outs.items():
            arrays[f"{name}|out|{k!r}"] = np.asarray(v, np.float32)
        for tag, c in cs.mesh_counts(rts).items():
            for k, v in c.items():
                arrays[f"{name}|cnt|{tag}|{k}"] = v
    np.savez(os.path.join(sys.argv[1], "ref.npz"), **arrays)
    _, msg, holders = tm.mesh_hang(J, make)
    with open(os.path.join(sys.argv[1], "hang.json"), "w") as f:
        json.dump({"msg": msg, "holders": [int(h) for h in holders]}, f)
""").replace("@SRC@", repr(str(ROOT / "src"))).replace(
    "@TESTS@", repr(str(ROOT / "tests"))).replace("@ROOT@", repr(str(ROOT)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out / "ref.npz") as z:
        arrays = dict(z)
    return arrays, json.loads((out / "hang.json").read_text())


def _port(name: str, on_mesh: bool):
    make = CS.mesh_maker(T, torch.device("cpu"), MESH if on_mesh else None)
    return CS.MESH_WORKLOADS[name](T, make)


@pytest.mark.parametrize("name", list(CS.MESH_WORKLOADS))
def test_mesh_equals_reference_mesh_and_port_sim(reference, name):
    arrays, _ = reference
    rts, outs = _port(name, on_mesh=True)
    counts = CS.mesh_counts(rts)
    ref_outs = {k.split("|", 2)[2]: v for k, v in arrays.items()
                if k.startswith(f"{name}|out|")}
    assert sorted(ref_outs) == sorted(repr(k) for k in outs)
    for k, v in outs.items():
        want = ref_outs[repr(k)]
        assert np.asarray(v, np.float32).tobytes() == want.tobytes(), k
    for tag, c in counts.items():
        for k in COUNTERS + ("staging_sharded_flushes",):
            np.testing.assert_array_equal(
                c[k], arrays[f"{name}|cnt|{tag}|{k}"], err_msg=(tag, k))
    # The reference's counts as chip_smoke.py holds the card to them.
    assert CS.mesh_summary(counts) == CS.MESH_REF[name]
    srts, souts = _port(name, on_mesh=False)
    for k, v in outs.items():
        assert (np.asarray(v, np.float32).tobytes()
                == np.asarray(souts[k], np.float32).tobytes()), k
    for tag, c in CS.mesh_counts(srts).items():
        for k in COUNTERS:
            np.testing.assert_array_equal(c[k], counts[tag][k],
                                          err_msg=(tag, k))
        assert c["staging_sharded_flushes"] == 0
    for tag, rt in rts.items():
        assert rt.stats()["launches"] == srts[tag].stats()["launches"]


@pytest.mark.parametrize("name", ["adversarial", "packed"])
def test_mesh_over_two_device_entries_equals_sim(name):
    """``cpu`` and ``cpu:0`` are two mesh entries (the ticker keys its
    tables, exchange plan and vote by device) over one memory: the ticker
    takes its several-device branch (eager, a vote on each device) and
    stays bit-equal to the sim.  The copies between two real devices run
    on the card (chip_smoke.py phase 4d, 4 x cuda + 4 x cpu)."""
    two = ["cpu"] * 4 + [torch.device("cpu", 0)] * 4
    rts, outs = CS.MESH_WORKLOADS[name](
        T, CS.mesh_maker(T, torch.device("cpu"), two))
    for rt in rts.values():
        tk = rt._ticker
        assert tk.multi and not tk.graphed and tk.streams is None
        assert len(tk.vote_devices) == 2
    srts, souts = _port(name, on_mesh=False)
    for k, v in outs.items():
        assert (np.asarray(v, np.float32).tobytes()
                == np.asarray(souts[k], np.float32).tobytes()), k
    counts = CS.mesh_counts(rts)
    for tag, c in CS.mesh_counts(srts).items():
        for k in COUNTERS:
            np.testing.assert_array_equal(c[k], counts[tag][k],
                                          err_msg=(tag, k))
    assert CS.mesh_summary(counts) == CS.MESH_REF[name]


def _ticked_state(splits, builder: bool):
    """The chained workload's setup on the mesh, then one launch prologue
    and ``tick`` calls of the given sizes, through the runtime's
    ``tick_fn`` or ``build_shardmap_tick``; returns the gathered state."""
    rt = T.OcclRuntime(T.OcclConfig(
        n_ranks=8, max_colls=8, max_comms=3, slice_elems=8, conn_depth=4,
        heap_elems=1 << 13, superstep_budget=1 << 14), mesh=MESH)
    world = rt.communicator(list(range(8)))
    ids = [rt.register(T.CollKind.ALL_REDUCE, world, n_elems=n,
                       algo="two_level", hierarchy=(2, 4)) for n in (96, 56)]
    rng = np.random.RandomState(0)
    for r in range(8):
        for cid in (ids if r % 2 == 0 else ids[::-1]):
            n = 96 if cid == ids[0] else 56
            rt.submit(r, cid, data=rng.randn(n).astype(np.float32))
    rt._ensure_built()
    rt._flush_staged()
    st = launch_prologue(rt.queues.pack_sq(rt._state))
    tick = (build_shardmap_tick(rt.cfg, rt._tables, MESH, barrier=True)
            if builder else rt.tick_fn())
    for k in splits:
        st, flags = tick(st, k)
    return st.gather(), flags


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("a,b", [(1, 7), (5, 11), (16, 3)])
def test_mesh_tick_batching_invariance(a, b):
    """On the mesh, tick(a) then tick(b) equals tick(a + b): every leaf
    but the tick-call counter, and the flags (the one tick through
    ``build_shardmap_tick``, the two through the runtime's machine)."""
    (st2, f2), (st1, f1) = (_ticked_state([a, b], False),
                            _ticked_state([a + b], True))
    assert int(st1.supersteps.max()) == a + b
    for f in T.DaemonState._fields:
        x, y = getattr(st2, f), getattr(st1, f)
        if f == "tick_calls":
            assert (x == y + 1).all()
            continue
        assert torch.equal(_bits(x), _bits(y)), f
    assert [int(f2.steps), bool(f2.live), bool(f2.drained)] == [
        b, bool(f1.live), bool(f1.drained)]


def test_mesh_hang_raises_reference_diagnosis(reference):
    _, ref = reference
    make = CS.mesh_maker(T, torch.device("cpu"), MESH)
    rt, msg, holders = mesh_hang(T, make)
    assert holders == ref["holders"] == [5]
    assert msg == ref["msg"]
    assert "held by rank(s) 5" in msg


def _mesh_runtime(**kw):
    return T.OcclRuntime(T.OcclConfig(n_ranks=8, max_comms=1, slice_elems=8,
                                      heap_elems=1 << 10), **kw)


def test_mesh_evict_and_device_api_raise():
    rt = _mesh_runtime(mesh=MESH)
    rt.register(T.CollKind.ALL_REDUCE, rt.communicator(list(range(8))),
                n_elems=16)
    with pytest.raises(NotImplementedError, match="sim-backend only"):
        rt.evict(3)
    with pytest.raises(NotImplementedError, match="sim-backend only"):
        rt.device_api()


def test_mesh_construction_checks():
    with pytest.raises(ValueError, match="one device per rank"):
        _mesh_runtime(mesh=["cpu"] * 7)
    with pytest.raises(ValueError, match="not both"):
        _mesh_runtime(mesh=MESH, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _mesh_runtime(mesh=["cuda"] * 8)


def test_mesh_state_is_per_rank():
    """Rank r's leaves live in its own shard with a leading axis of 1; the
    runtime's ``state`` gathers the [R, ...] view; an all-ranks write is
    one sharded flush."""
    rt = _mesh_runtime(mesh=MESH)
    cid = rt.register(T.CollKind.ALL_REDUCE, rt.communicator(list(range(8))),
                      n_elems=16)
    rt.write_inputs_bulk({(r, cid): np.full(16, r + 1.0, np.float32)
                          for r in range(8)})
    shards = rt._state.shards
    assert len(shards) == 8
    assert all(s.heap_in.shape[0] == 1 for s in shards)
    assert rt._staging.sharded_flushes == 1
    full = rt.state
    assert full.heap_in.shape[0] == 8
    for r in range(8):
        assert torch.equal(full.heap_in[r], shards[r].heap_in[0])
        assert int((shards[r].heap_in[0] == r + 1).sum()) == 16
    # One launch of build_shardmap_daemon on the runtime's state completes
    # the all-reduce on every rank.
    rt.submit_all(cid)
    st = build_shardmap_daemon(rt.cfg, rt._tables, MESH)(
        rt.queues.pack_sq(rt._state))
    assert (st.completed[:, int(cid)] == 1).all()
    assert rt.queues.reconcile(st) == 8
    rt._state = st
    for r in range(8):
        np.testing.assert_array_equal(rt.read_output(r, cid),
                                      np.full(16, 36.0, np.float32))
