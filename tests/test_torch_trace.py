"""The port's in-program tracer (``repro_torch.core.trace``) and the
runtime's chunk and staging counters.

* Off (the default), a ``drive()`` and a ``DeviceApi.tick_until`` leave the
  tracer empty and build no CUDA event, open no profiler range and sync no
  device (each patched to raise).
* On, spans nest with the right parents and self times; ``occl.chunk``
  units add up to the bodies ``stats()`` counts, all eager on the CPU;
  the loop gap and the device time fold from event pairs (fake events on
  the CPU); a profiler session sees ``occl:`` ranges and the clock marker.
* ``staging_read_bytes`` equals the bytes a bulk read returned; a launch's
  record holds its supersteps and slices without the device epoch.
* Final states and outputs are bit-identical with tracing on and off, for
  a sim ``drive()`` (one-shot and tick path), a mesh ``drive()`` and an
  in-step overlap step.
* On a card (marker ``card``): a captured chunk's kernel node count is
  positive and the same on a second capture; a capture runs with the
  collector off.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.core import CollKind, OcclConfig, OcclRuntime, trace
from repro_torch.core.state import DaemonState
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.train.occl_sync import OcclGradSync
from repro_torch.train.state import init_state
from repro_torch.train.step import make_overlap_grads_step
from torch_parity import bits, one_torch_thread  # noqa: F401 (autouse)

R, N = 4, 128      # N fills whole slices on every rank: no pads


@pytest.fixture(autouse=True)
def fresh_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def runtime(mesh=False, budget=1 << 14):
    cfg = OcclConfig(n_ranks=R, max_colls=2, max_comms=1, slice_elems=8,
                     conn_depth=4, heap_elems=4096,
                     superstep_budget=budget)
    rt = (OcclRuntime(cfg, mesh=[torch.device("cpu")] * R) if mesh
          else OcclRuntime(cfg, device="cpu"))
    cm = rt.communicator(list(range(R)))
    return rt, rt.register(CollKind.ALL_REDUCE, cm, n_elems=N)


def drive_once(mesh=False, tick_k=None, budget=1 << 14, rounds=2):
    """Rounds of one all-reduce; returns the runtime and its outputs."""
    rt, cid = runtime(mesh, budget)
    outs = {}
    for it in range(rounds):
        for r in range(R):
            rt.submit(r, cid, data=np.arange(N, dtype=np.float32) * (r + it))
        rt.drive(tick_k=tick_k)
        for (r, c), v in rt.read_outputs_bulk(
                [(r, cid) for r in range(R)]).items():
            outs[(it, r)] = v
    return rt, cid, outs


def tick_until_once():
    rt, cid = runtime()
    api = rt.device_api()
    st = api.step_prologue(rt.state, ticks=(4,))
    st = api.submit_all(st, cid, torch.ones(R, N))
    st = api.tick_until(st, lambda s: (api.completed(s, cid) >= 1).all(),
                        chunk=4)
    rt.adopt_state(st)
    return rt, api.read_all(st, cid)


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


def leaves_equal(a: DaemonState, b: DaemonState) -> None:
    for f, x, y in zip(DaemonState._fields, a, b):
        assert same_bits(x, y), f


def by_seq(snap):
    return {r["seq"]: r for r in snap["records"]}


def forbid(what):
    def boom(*a, **kw):
        raise AssertionError(f"{what} used with tracing off")
    return boom


def test_tracing_off_builds_no_event_range_or_sync(monkeypatch):
    for mod, name in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                      (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(mod, name, forbid(name))
    assert not trace._on
    rt, _, _ = drive_once()
    tick_until_once()
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["records"] == []
    assert snap["dropped"] == 0 and snap["clock"] == []
    assert rt.stats()["eager_supersteps"] > 0      # the counters still count


def test_spans_nest_with_parents_and_self_times():
    trace.enable()
    with trace.span("outer", units=3):
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            with trace.span("leaf"):
                pass
    snap = trace.snapshot()
    recs = {r["name"]: r for r in snap["records"]}   # last of each name
    seqs = by_seq(snap)
    assert seqs[recs["leaf"]["parent"]]["name"] == "inner"
    assert seqs[recs["inner"]["parent"]]["name"] == "outer"
    assert recs["outer"]["parent"] == 0 and recs["outer"]["units"] == 3
    sp = snap["spans"]
    assert (sp["outer"]["count"], sp["inner"]["count"],
            sp["leaf"]["count"]) == (1, 2, 1)
    dur = lambda r: r["t1_ns"] - r["t0_ns"]
    inner = [r for r in snap["records"] if r["name"] == "inner"]
    assert sp["outer"]["self_s"] == pytest.approx(
        (dur(recs["outer"]) - sum(map(dur, inner))) / 1e9, abs=1e-12)
    assert sp["inner"]["self_s"] == pytest.approx(
        (sum(map(dur, inner)) - dur(recs["leaf"])) / 1e9, abs=1e-12)
    assert sp["leaf"]["self_s"] == sp["leaf"]["host_s"]


@pytest.mark.parametrize("mesh,tick_k", [(False, None), (False, 4),
                                         (True, None)])
def test_drive_spans_and_eager_chunks(mesh, tick_k):
    trace.enable()
    rt, _, _ = drive_once(mesh, tick_k)
    snap = trace.snapshot()
    st = rt.stats()
    sp, seqs = snap["spans"], by_seq(snap)
    for r in snap["records"]:
        if r["name"] in ("occl.chunk", "occl.flag_read"):
            assert seqs[r["parent"]]["name"] == "occl.loop"
        if r["name"] in ("occl.loop", "occl.flush", "occl.read"):
            assert r["parent"] == 0
    assert sp["occl.loop"]["count"] == st["launches"]
    assert sp["occl.flag_read"]["count"] == sp["occl.chunk"]["count"]
    assert sp["occl.flush"]["count"] == 2 and sp["occl.read"]["count"] == 2
    # every CPU superstep body is eager, and the chunk units are its count
    assert sp["occl.chunk"]["units"] == st["eager_supersteps"]
    assert st["eager_supersteps"] >= int(st["supersteps"].max())
    assert (st["graph_supersteps"], st["graph_replays"],
            st["graph_captures"], st["graph_kernel_nodes"],
            st["graph_replays_by_tick"]) == (0, 0, 0, {}, {})
    assert sp["occl.chunk"]["device_s"] == 0 and sp["occl.loop"]["gaps"] == 0
    loop = sp["occl.loop"]
    assert loop["self_s"] == pytest.approx(
        loop["host_s"] - sp["occl.chunk"]["host_s"]
        - sp["occl.flag_read"]["host_s"], abs=1e-9)


def test_tick_until_is_one_loop_with_a_flag_read_per_slice():
    trace.enable()
    rt, _ = tick_until_once()
    sp = trace.snapshot()["spans"]
    assert sp["occl.loop"]["count"] == 1
    # one read per slice ticked, and the last read ends the loop
    assert sp["occl.flag_read"]["count"] == sp["occl.chunk"]["count"] + 1
    assert sp["occl.chunk"]["units"] == 4 * sp["occl.chunk"]["count"] \
        == rt.stats()["eager_supersteps"]


def test_read_bytes_are_the_bytes_returned():
    rt, cid, outs = drive_once()
    st = rt.stats()
    got = sum(v.nbytes for v in outs.values())
    assert got == 2 * R * N * 4
    assert st["staging_read_bytes"] == got
    assert st["staging_flush_bytes"] == got        # no pads: N fills slices


def test_launch_record_holds_steps_and_slices_not_the_epoch():
    rt, _, _ = drive_once(budget=24)               # several launches a drive
    st = rt.stats()
    hist = st["launch_history"]
    assert len(hist) == st["launches"] > 2
    assert all(set(h) == {"launch_steps", "slices_moved", "completions"}
               for h in hist)
    assert sum(h["slices_moved"] for h in hist) == int(
        st["slices_moved"].sum())
    assert hist[-1]["launch_steps"] == int(st["launch_steps"].max())
    assert sum(h["completions"] for h in hist) == 2 * R
    assert int(st["epoch"].max()) == st["launches"]


@pytest.mark.parametrize("mesh,tick_k", [(False, None), (False, 4),
                                         (True, None)])
def test_tracing_leaves_drive_bit_identical(mesh, tick_k):
    rt0, _, out0 = drive_once(mesh, tick_k)
    trace.enable()
    rt1, _, out1 = drive_once(mesh, tick_k)
    assert trace.snapshot()["spans"]["occl.chunk"]["count"] > 0
    leaves_equal(rt0.state, rt1.state)
    assert out0.keys() == out1.keys()
    for k in out0:
        np.testing.assert_array_equal(bits(out1[k]), bits(out0[k]))


def overlap_step():
    dp = 2
    cfg = tget("qwen3-0.6b").reduced()
    cell = ShapeCell("t", 16, dp, "train")
    states = [init_state(cfg, device="cpu") for _ in range(dp)]
    batches = [SyntheticPipeline(cfg, cell, shard_id=r,
                                 n_shards=dp).batch_at(0) for r in range(dp)]
    sync = OcclGradSync(init_state(cfg, device="meta").params, dp,
                        device="cpu", bucket_elems=16384, slice_elems=512)
    step = make_overlap_grads_step(cfg, sync, ticks_per_boundary=4)
    st, losses, grads = step(sync.occl.state, [s.params for s in states],
                             batches)
    return st, losses, grads


def test_tracing_leaves_overlap_step_bit_identical():
    from repro_torch.tree import tree_leaves

    st0, loss0, g0 = overlap_step()
    trace.enable()
    st1, loss1, g1 = overlap_step()
    sp = trace.snapshot()["spans"]
    assert sp["occl.loop"]["count"] == 1           # the drain
    # the drain reads once per chunk and once more; the boundary ticks
    # inside the backward pass are chunks outside any loop
    assert sp["occl.chunk"]["count"] >= sp["occl.flag_read"]["count"]
    leaves_equal(st0, st1)
    for a, b in zip(loss0, loss1):
        assert same_bits(a, b)
    for r in range(len(g0)):
        for a, b in zip(tree_leaves(g0[r]), tree_leaves(g1[r])):
            assert same_bits(a, b)


class FakeEvent:
    """A timing event on a fake device clock: ``record`` stamps the clock,
    which the test advances."""
    now = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        self.t = FakeEvent.now

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t                      # ms


def test_device_pairs_fold_into_chunk_time_and_loop_gaps(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    FakeEvent.now, FakeEvent.made = 0.0, 0
    trace.enable()
    made = FakeEvent.made
    for _ in range(3):
        with trace.span("occl.loop"):
            for _ in range(4):                     # chunks of 10 ms
                with trace.span("occl.chunk", device=True, units=16):
                    FakeEvent.now += 10.0
                FakeEvent.now += 0.5               # the host's flag read
        FakeEvent.now += 100.0                     # work between loops
    with trace.span("occl.chunk", device=True, units=8):   # no loop
        FakeEvent.now += 5.0
    sp = trace.snapshot()["spans"]
    assert FakeEvent.made == made                  # the pool sufficed
    assert sp["occl.chunk"]["device_s"] == pytest.approx(0.125)
    assert sp["occl.chunk"]["device_units"] == 12 * 16 + 8
    assert sp["occl.loop"]["gaps"] == 9            # 3 between 4 chunks
    assert sp["occl.loop"]["gap_s"] == pytest.approx(9 * 0.0005)
    assert sp["occl.loop"]["chunk_device_s"] == pytest.approx(0.12)


def test_profiler_sees_ranges_and_the_clock_marker():
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drive_once(rounds=1)
    snap = trace.snapshot()
    names = [e.name for e in prof.events()]
    assert "occl:clock" in names
    # every span opened under the profiler has its range
    for n in ("occl.loop", "occl.chunk", "occl.flag_read", "occl.flush",
              "occl.read"):
        assert names.count("occl:" + n) == snap["spans"][n]["count"], n
    assert len(snap["clock"]) == 2                 # enable() and profiler
    c = snap["clock"][-1]
    assert c["t0_ns"] <= c["t1_ns"] <= snap["records"][0]["t0_ns"]


@pytest.mark.card
def test_captured_chunk_kernel_nodes_are_counted_alike():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts = []
    for _ in range(2):
        cfg = OcclConfig(n_ranks=R, max_colls=2, max_comms=1, slice_elems=8,
                         conn_depth=4, heap_elems=4096)
        rt = OcclRuntime(cfg, device="cuda")
        cid = rt.register(CollKind.ALL_REDUCE,
                          rt.communicator(list(range(R))), n_elems=N)
        for it in range(3):
            for r in range(R):
                rt.submit(r, cid, data=np.ones(N, np.float32))
            rt.drive()
        st = rt.stats()
        assert st["graph_captures"] >= 1 and st["graph_replays"] >= 1
        assert sum(st["graph_replays_by_tick"].values()) \
            == st["graph_replays"]
        assert st["graph_supersteps"] == sum(
            k * n for k, n in st["graph_replays_by_tick"].items())
        counts.append(st["graph_kernel_nodes"])
    assert counts[0] == counts[1]
    assert counts[0] and all(n > 0 for n in counts[0].values())


@pytest.mark.card
def test_capture_runs_with_the_collector_off(monkeypatch):
    """The collector freeing a dead runtime's CUDA graph (the ticker and its
    chunk runners form a reference cycle) while another runtime captures
    invalidates that capture, so a capture runs with automatic collection
    off, and turns it back on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import daemon

    real, seen = daemon.SimTicker._bodies, []

    def bodies(self, st, inbox, k):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return real(self, st, inbox, k)

    monkeypatch.setattr(daemon.SimTicker, "_bodies", bodies)
    assert gc.isenabled()
    cfg = OcclConfig(n_ranks=R, max_colls=2, max_comms=1, slice_elems=8,
                     conn_depth=4, heap_elems=4096)
    rt = OcclRuntime(cfg, device="cuda")
    cid = rt.register(CollKind.ALL_REDUCE, rt.communicator(list(range(R))),
                      n_elems=N)
    for r in range(R):
        rt.submit(r, cid, data=np.full(N, r + 1, np.float32))
    rt.drive()
    assert rt.stats()["graph_captures"] == 1
    assert seen == [False] and gc.isenabled()
    for v in rt.read_outputs_bulk([(r, cid) for r in range(R)]).values():
        np.testing.assert_array_equal(v, np.full(N, R * (R + 1) / 2))
