"""The sim superstep's kernels (``kernels/superstep.py``,
``csrc/superstep.cu``) against the plain body, leaf by leaf and bitwise.

CPU tests: the daemon's superstep (``daemon._sim_step_fn``) takes the
plain body (``daemon._sim_body_fn``) on CPU tensors and launches nothing;
:func:`fused_superstep` refuses what the kernels do not take, CPU tensors
included.  Card tests (marker ``card``; skipped without a card): the
daemon's superstep on the card (the kernels) against the plain body on the
CPU from the same states, over ``superstep_cases``' sweep (the states of
``test_torch_superstep.py``'s ``CAPTURE`` supersteps and every superstep of
the chained workload up to its last hand-off), a body started not live,
and whole runs of ticks of 1, 8 and 16 supersteps (CUDA graph replays).
This file imports no JAX: on the card run it with

    PYTHONPATH=src python -m pytest -m card tests/test_torch_superstep_kernel.py
"""
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import daemon
from repro_torch.core import state_from_numpy, state_to_numpy, tables_from_numpy
from repro_torch.core.scheduler import Mailbox
from repro_torch.kernels import superstep as ks

import superstep_cases
from superstep_cases import CAPTURE, CONFIGS

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

NAMES = list(CONFIGS) + ["chain"]
SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "superstep.cu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _build(name):
    if name == "chain":
        return superstep_cases.build_chain_workload(T, device="cpu")
    return superstep_cases.build_workload(T, CONFIGS[name], device="cpu")


def _mailbox_np(mb) -> dict:
    return {f: _bits(v) for f, v in mb._asdict().items()}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values, floats as their bit patterns."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _mailbox(d: dict, dtype, device) -> Mailbox:
    out = {f: torch.from_numpy(a.copy()) for f, a in d.items()}
    out["fwd_payload"] = out["fwd_payload"].view(dtype)
    return Mailbox(**{f: t.to(device) for f, t in out.items()})


@functools.lru_cache(maxsize=None)
def _states(name):
    """[(state, mailbox)] numpy snapshots of the plain body stepped on the
    CPU from a launch prologue: the CAPTURE supersteps, or every superstep
    up to the chained workload's last hand-off."""
    cfg, kw, rt = _build(name)
    t = rt._tables
    sh, lt, fwd, rev = tables_from_numpy(t, "cpu")
    body = daemon._sim_body_fn(
        cfg, daemon._edge_plan(daemon._relink_edges(t), "cpu"))
    st = daemon.launch_prologue(rt.queues.pack_sq(rt.state))
    inbox = daemon._load_mailbox(st)
    capture = range(26) if name == "chain" else CAPTURE
    out = []
    for i in range(max(capture) + 1):
        if i in capture:
            out.append((state_to_numpy(st), _mailbox_np(inbox)))
        st, inbox = body(sh, lt, fwd, rev, st, inbox)
    return cfg, t, out


def _inputs(cfg, t, snap, device):
    st_np, mb_np = snap
    st = state_from_numpy(st_np, cfg, device)
    tables = tables_from_numpy(t, device)
    plan = daemon._edge_plan(daemon._relink_edges(t), device)
    return (plan, tables, st, _mailbox(mb_np, st.payload.dtype, device),
            torch.zeros((), dtype=torch.int32, device=device))


def _diff(got: dict, want: dict) -> list:
    """The fields that differ, each with its first differing index."""
    bad = []
    for f in want:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if w.dtype == np.float32:           # NaN's bits compare equal
            g, w = g.view(np.int32), w.view(np.int32)
        if g.shape != w.shape:
            bad.append((f, "shape", g.shape, w.shape))
        elif not np.array_equal(g, w):
            idx = tuple(int(i) for i in np.argwhere(g != w)[0])
            bad.append((f, idx, g[idx], w[idx]))
    return bad


def _step(name, snap, device):
    cfg, t, _ = _states(name)
    plan, tables, st, inbox, steps = _inputs(cfg, t, snap, device)
    step = daemon._sim_step_fn(cfg, plan, device)
    st, inbox, steps = step(*tables, st, inbox, steps)
    return state_to_numpy(st), _mailbox_np(inbox), int(steps)


# ---------------------------------------------------------------------------
# CPU: routing and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_plain_body(name):
    """On the CPU the daemon's superstep IS the plain body: the same
    leaves, bit for bit, the live flag counted into ``steps``, and no
    kernel launch."""
    cfg, t, snaps = _states(name)
    launches = ks.fused_superstep.launches
    for snap in snaps[:4]:
        plan, (sh, lt, fwd, rev), st, inbox, _ = _inputs(cfg, t, snap, "cpu")
        live = int(st.global_live[0])
        want_st, want_in = daemon._sim_body_fn(cfg, plan)(sh, lt, fwd, rev,
                                                          st, inbox)
        got = _step(name, snap, "cpu")
        assert _diff(got[0], state_to_numpy(want_st)) == []
        assert _diff(got[1], _mailbox_np(want_in)) == []
        assert got[2] == live
    assert ks.fused_superstep.launches == launches


def test_cpu_ticker_launches_no_superstep_kernel():
    cfg, kw, rt = _build("b4_prio")
    tick = daemon.SimTicker(cfg, rt._tables, "cpu")
    st = daemon.launch_prologue(rt.queues.pack_sq(rt.state))
    launches = ks.fused_superstep.launches
    st, flags = tick.tick(st, 16, barrier=True)
    assert int(flags.steps) == 16
    assert ks.fused_superstep.launches == launches
    stats = daemon.chunk_stats(tick)
    assert stats["superstep_launches"] == 0
    assert stats["eager_supersteps"] == 16


def _bad(kind):
    """(inputs with one fault of ``kind``, the error it raises)."""
    cfg, t, snaps = _states("b1_fr")
    plan, (sh, lt, fwd, rev), st, inbox, steps = _inputs(cfg, t, snaps[1],
                                                         "cpu")
    meta = lambda x: torch.empty_like(x, device="meta")
    if kind == "dtype":
        st = st._replace(arrival=st.arrival.long())
        err = (TypeError, "arrival must be torch.int32")
    elif kind == "shape":
        inbox = inbox._replace(fwd_count=inbox.fwd_count[:, :1])
        err = (ValueError, "inbox.fwd_count must be")
    elif kind == "heap_dtype":
        st = st._replace(payload=st.payload.double())
        err = (TypeError, "payload must be torch.float32")
    elif kind == "non_contiguous":
        st = type(st)(*(meta(x) for x in st))
        inbox = Mailbox(*(meta(x) for x in inbox))
        sh = type(sh)(*(meta(x) for x in sh))
        lt = type(lt)(*(meta(x) for x in lt))
        fwd, rev, steps = meta(fwd), meta(rev), meta(steps)
        spin = torch.empty((st.spin.shape[1], st.spin.shape[0]),
                           dtype=torch.int32, device="meta").T
        st = st._replace(spin=spin)
        err = (ValueError, "spin must be contiguous")
    elif kind == "mixed_device":
        st = st._replace(tail=meta(st.tail))
        err = (ValueError, "different devices")
    elif kind == "cpu":
        err = (ValueError, "unsupported device cpu")
    else:
        assert kind == "meta"
        st = type(st)(*(meta(x) for x in st))
        inbox = Mailbox(*(meta(x) for x in inbox))
        sh = type(sh)(*(meta(x) for x in sh))
        lt = type(lt)(*(meta(x) for x in lt))
        fwd, rev, steps = meta(fwd), meta(rev), meta(steps)
        err = (ValueError, "unsupported device meta")
    return (daemon._superstep_settings(cfg), sh, lt, fwd, rev, st, inbox,
            steps, bool(plan)), err


@pytest.mark.parametrize("kind", ["dtype", "shape", "heap_dtype",
                                  "non_contiguous", "mixed_device", "meta",
                                  "cpu"])
def test_wrapper_refuses_what_the_kernels_do_not_take(kind):
    args, (exc, match) = _bad(kind)
    launches = ks.fused_superstep.launches
    with pytest.raises(exc, match=match):
        ks.fused_superstep(*args)
    assert ks.fused_superstep.launches == launches


def test_argument_tables_match_the_source():
    """The wrapper's pointer and size lists have the lengths and the order
    of the CUDA source's ``Args``."""
    src = SOURCE.read_text()
    assert f"constexpr int kPtrs = {ks.N_PTRS};" in src
    assert f"constexpr int kDims = {ks.N_DIMS};" in src
    unpack = src[src.index("bool unpack("):src.index("if (i != kPtrs)")]
    fields = re.findall(r"a\.(\w+) = (?:[IUX]\(\)|static_cast)", unpack)
    names = ([f for f, _, _ in ks._STATE] + [f for f, _, _ in ks._MAILBOX]
             + [f for f, _, _ in ks._SHARED] + [f for f, _, _ in ks._LOCAL]
             + ["fwd_src", "rev_src", "lanes", "write", "aux", "raux",
                "mirrors", "fired", "outbox", "steps"])
    assert fields == names and len(names) == ks.N_PTRS
    cfg, t, snaps = _states("b1_fr")
    _, (sh, lt, _, _), st, inbox, _ = _inputs(cfg, t, snaps[0], "cpu")
    dims = ks._dims(ks._sizes(sh, lt, st, inbox),
                    daemon._superstep_settings(cfg), False)
    assert len(dims) == ks.N_DIMS
    assert dims[:10] == [cfg.n_ranks, cfg.max_colls, cfg.max_comms,
                         cfg.burst_slices, cfg.conn_depth,
                         lt.prog_kind.shape[-1], sh.prim_recv.shape[0],
                         cfg.sq_len, cfg.cq_len, cfg.recorder_len]
    aux = src[src.index("enum Aux {"):src.index("kAux\n};")]
    assert len(re.findall(r"A_\w+", aux)) == ks.N_AUX


@pytest.mark.parametrize("row, ptrs, unit", [
    (4096, (0, 256), 16), (16, (0, 8), 8), (8, (0, 4), 4), (6, (0, 2), 2),
    (32, (2, 16), 2), (3, (0, 0), 1)])
def test_copy_unit_divides_row_and_pointers(row, ptrs, unit):
    assert ks._copy_unit(row, *ptrs) == unit


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_kernel_body_equals_plain_body(card, name):
    """Every captured state: one kernel superstep on the card equals one
    plain superstep on the CPU, every state leaf and every mailbox leaf,
    and launches the two kernels once each."""
    _, _, snaps = _states(name)
    moved = 0
    for k, snap in enumerate(snaps):
        want = _step(name, snap, "cpu")
        launches = ks.fused_superstep.launches
        got = _step(name, snap, card)
        assert ks.fused_superstep.launches == launches + 2
        assert _diff(got[0], want[0]) == [], f"{name} state {k}"
        assert _diff(got[1], want[1]) == [], f"{name} mailbox {k}"
        assert got[2] == want[2]
        moved += int(want[1]["fwd_count"].sum())
    assert moved > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["b4_prio", "chain"])
def test_not_live_kernel_body_changes_nothing(card, name):
    """Started not live, the kernel body writes no leaf: heaps, state,
    mailbox and the step count stay as they were."""
    cfg, t, snaps = _states(name)
    for snap in snaps[1:]:
        plan, tables, st, inbox, steps = _inputs(cfg, t, snap, card)
        st = st._replace(global_live=torch.zeros_like(st.global_live))
        before = state_to_numpy(st), _mailbox_np(inbox)
        step = daemon._sim_step_fn(cfg, plan, card)
        st, inbox, steps = step(*tables, st, inbox, steps)
        assert _diff(state_to_numpy(st), before[0]) == []
        assert _diff(_mailbox_np(inbox), before[1]) == []
        assert int(steps) == 0


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("name", ["b4_prio", "b1_ablate", "b4_bf16",
                                  "chain"])
def test_ticks_on_card_equal_ticks_on_cpu(card, name, k):
    """Whole runs of k-superstep ticks (captured and replayed as CUDA graphs
    on the card) until the launch ends: after every tick the card's state
    equals the CPU's, trajectories, CQ, counters and flight recorder
    included, and the superstep kernels ran every superstep."""
    cfg, kw, rt = _build(name)
    if name != "chain":     # a budget that ends the launch mid-run
        cfg = T.OcclConfig(**dict(kw, superstep_budget=40))
    start = state_to_numpy(daemon.launch_prologue(
        rt.queues.pack_sq(rt.state)))
    ticks, sts = {}, {}
    for dev in ("cpu", card):
        ticks[dev] = daemon.SimTicker(cfg, rt._tables, dev)
        sts[dev] = state_from_numpy(start, cfg, dev)
    launches = ks.fused_superstep.launches
    steps = 0
    for call in range(400):
        flags = {}
        for dev in ticks:
            sts[dev], flags[dev] = ticks[dev].tick(sts[dev], k, barrier=True)
        assert _diff(state_to_numpy(sts[card]),
                     state_to_numpy(sts["cpu"])) == [], f"tick {call}"
        f_cpu, f_card = flags["cpu"], flags[card]
        assert (int(f_card.steps), bool(f_card.live), bool(f_card.drained)) \
            == (int(f_cpu.steps), bool(f_cpu.live), bool(f_cpu.drained))
        steps += int(f_cpu.steps)
        if not bool(f_cpu.live):
            break
    assert not bool(f_cpu.live) and steps > 0
    stats = daemon.chunk_stats(ticks[card])
    assert stats["superstep_launches"] == 2 * k * (call + 1)
    assert ks.fused_superstep.launches - launches == 2 * k * (call + 1)
    if call >= 1:
        assert stats["graph_replays"] == call


@pytest.mark.card
@pytest.mark.parametrize("name", ["b4_prio", "chain"])
def test_runtime_drive_on_card_equals_cpu(card, name):
    """A runtime's daemon launches (chunks of ``TICK_CHUNK``, the tail
    chunk eager) on the card end in the CPU's state and outputs."""
    runs = {}
    for dev in ("cpu", card):
        if name == "chain":
            _, _, rt = superstep_cases.build_chain_workload(T, device=dev)
        else:
            _, _, rt = superstep_cases.build_workload(T, CONFIGS[name],
                                                      device=dev)
        rt.drive()
        runs[dev] = rt
    assert _diff(state_to_numpy(runs[card].state),
                 state_to_numpy(runs["cpu"].state)) == []
    stats = runs[card].stats()
    assert stats["superstep_launches"] > 0
    assert runs["cpu"].stats()["superstep_launches"] == 0
