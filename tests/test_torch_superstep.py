"""One superstep, port against reference, leaf by leaf and bitwise.

States are taken mid-run from the reference (``repro``) sim daemon stepped
by hand (``rank_superstep`` under ``vmap`` + ``_sim_exchange``, the
recipe of ``.claude/skills/verify/SKILL.md``), carried into the port with
``state_from_numpy`` / ``tables_from_numpy``, and advanced by one port
``rank_superstep`` over all ranks at once.  Every leaf of the resulting
state and of the outbox must equal the reference's bit for bit.

The sweep covers burst widths 1 and 4, the flight recorder on and off (and
a ring shorter than one superstep's events), FIFO and PRIORITY with
preemption and aging, the stickiness / demand-steering / stall-weight
ablations, every reduce op and a bfloat16 heap.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import daemon as jdaemon
from repro.core.scheduler import rank_superstep as j_rank_superstep
from repro_torch.core import OcclConfig as TConfig
from repro_torch.core import daemon as tdaemon
from repro_torch.core import state_from_numpy, state_to_numpy, tables_from_numpy
from repro_torch.core.scheduler import Mailbox as TMailbox
from repro_torch.core.scheduler import rank_superstep as t_rank_superstep
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

import superstep_cases
from superstep_cases import CAPTURE, CONFIGS, R

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _workload(cfg_kw):
    """A reference runtime with six collectives on two lanes, submitted in
    seeded per-rank orders (priorities random), flushed and packed."""
    return superstep_cases.build_workload(J, cfg_kw)


def _np_tree(t):
    return {k: np.array(v) for k, v in t._asdict().items()}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a: np.ndarray) -> np.ndarray:
    if str(a.dtype) == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _assert_leaves_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for f in want:
        w = _bits(want[f])
        g = _bits(got[f])
        assert g.shape == w.shape, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def _chain_workload():
    """A composite two-level all-reduce (a device-chained stage sequence on
    derived lanes) beside a flat all-gather, registered on the reference.
    The tables are carried into the port with ``tables_from_numpy``."""
    return superstep_cases.build_chain_workload(J)


@functools.lru_cache(maxsize=None)
def _captured(name, defer=True):
    """[(state, inbox, next_state, outbox)] numpy snapshots from the
    reference, at the CAPTURE supersteps of one launch (``defer``: the
    reference's ``defer_relink``)."""
    cfg, kw, rt = (_chain_workload() if name == "chain"
                   else _workload(CONFIGS[name]))
    t = rt._tables
    sh, lt = jdaemon.shared_tables(t), jdaemon.local_tables(t)
    fwd, rev = jnp.asarray(t.fwd_src), jnp.asarray(t.rev_src)
    step = jax.jit(jax.vmap(
        functools.partial(j_rank_superstep, cfg, sh, defer_relink=defer),
        in_axes=(0, 0, 0)))
    st = jdaemon.launch_prologue(rt.queues.pack_sq(rt.state))
    inbox = jdaemon._load_mailbox(st)
    out = []
    # Every superstep of the chain workload up to its last hand-off, so
    # the sweep includes the supersteps where chained stages complete.
    capture = range(26) if name == "chain" else CAPTURE
    for i in range(max(capture) + 1):
        nst, outbox = step(lt, st, inbox)
        if i in capture:
            out.append((_np_tree(st), _np_tree(inbox), _np_tree(nst),
                        _np_tree(outbox)))
        st, inbox = nst, jdaemon._sim_exchange(fwd, rev, outbox)
    return kw, t, out


@pytest.mark.parametrize("name", list(CONFIGS) + ["chain"])
def test_one_superstep_matches_reference_leaf_by_leaf(name):
    kw, t, snaps = _captured(name)
    cfg = TConfig(**kw)
    sh, lt, _, _ = tables_from_numpy(t, "cpu")
    moved = handoffs = 0
    assert t.has_chains == (name == "chain")
    for k, (st, inbox, want_st, want_out) in enumerate(snaps):
        tst = state_from_numpy(st, cfg, "cpu")
        tin = TMailbox(**{f: _to_torch(v) for f, v in inbox.items()})
        got_st, got_out = t_rank_superstep(cfg, sh, lt, tst, tin,
                                           defer_relink=True)
        _assert_leaves_equal(state_to_numpy(got_st), want_st,
                             f"{name} capture {k} state")
        got_out = {f: (v.view(torch.int16).numpy().view(np.uint16)
                       if v.dtype == torch.bfloat16 else v.numpy())
                   for f, v in got_out._asdict().items()}
        _assert_leaves_equal(got_out, want_out,
                             f"{name} capture {k} outbox")
        moved += int(want_out["fwd_count"].sum())
        handoffs += int((want_st["fr_kinds"] - st["fr_kinds"])[:, 3].sum())
    assert moved > 0            # the sweep saw real traffic
    if name == "chain":
        assert handoffs > 0     # ... and on-device chain hand-offs


@pytest.mark.parametrize("name", ["b4_prio", "b1_fr"])
def test_launch_prologue_matches_reference(name):
    kw, t, snaps = _captured(name)
    cfg = TConfig(**kw)
    for st, _, _, _ in snaps:
        want = _np_tree(jdaemon.launch_prologue(
            jax.tree_util.tree_map(jnp.asarray, _as_jstate(st))))
        got = state_to_numpy(tdaemon.launch_prologue(
            state_from_numpy(st, cfg, "cpu")))
        _assert_leaves_equal(got, want, f"{name} prologue")


def _as_jstate(d):
    from repro.core.state import DaemonState
    return DaemonState(**d)


def test_not_live_body_changes_no_leaf():
    """A superstep body run after the fabric went not-live (the tail of a
    host chunk) leaves every state leaf and the mailbox untouched."""
    kw, t, snaps = _captured("b4_prio")
    cfg = TConfig(**kw)
    sh, lt, fwd, rev = tables_from_numpy(t, "cpu")
    body = tdaemon._sim_body_fn(cfg)
    for st, inbox, _, _ in snaps[1:4]:
        tst = state_from_numpy(st, cfg, "cpu")
        tst = tst._replace(global_live=torch.zeros_like(tst.global_live))
        before = state_to_numpy(tst)
        tin = TMailbox(**{f: _to_torch(v) for f, v in inbox.items()})
        got, got_in = body(sh, lt, fwd, rev, tst, tin)
        _assert_leaves_equal(state_to_numpy(got), before, "gated state")
        for f, v in inbox.items():
            np.testing.assert_array_equal(getattr(got_in, f).numpy(), v)


@pytest.mark.parametrize("name", ["b4_prio", "b1_fr"])
def test_build_sim_tick_matches_reference_tick(name):
    """``build_sim_tick`` (k gated bodies per call, mailbox stored at the
    boundary, tick accounting) equals the reference's tick call for call,
    including the calls that run past the launch's end."""
    cfg_j, kw, rt = _workload(dict(CONFIGS[name], superstep_budget=40))
    t = rt._tables
    cfg = TConfig(**kw)
    jtick = jax.jit(jdaemon.build_sim_tick(cfg_j, t, barrier=False),
                    static_argnums=1)
    ttick = tdaemon.build_sim_tick(cfg, t, "cpu", barrier=False)
    jst = jdaemon.launch_prologue(rt.queues.pack_sq(rt.state))
    tst = state_from_numpy(_np_tree(jst), cfg, "cpu")
    for k in (7, 7, 30, 5):
        jst, jf = jtick(jst, k)
        tst, tf = ttick(tst, k)
        _assert_leaves_equal(state_to_numpy(tst), _np_tree(jst),
                             f"{name} tick k={k}")
        assert (int(tf.steps), bool(tf.live), bool(tf.drained)) == \
            (int(jf.steps), bool(jf.live), bool(jf.drained))
    assert not bool(tf.live)            # the last calls ran past the end


def test_chain_relink_fired_matches_reference():
    """The deferred chain-relink mask on the reference's composite tables,
    over seeded stage-completion deltas."""
    from repro.core.scheduler import chain_relink_fired as jfired
    from repro_torch.core.scheduler import chain_relink_fired as tfired

    kw, t, snaps = _captured("chain")
    jsh, jlt = jdaemon.shared_tables(t), jdaemon.local_tables(t)
    sh, lt, _, _ = tables_from_numpy(t, "cpu")
    vfired = jax.vmap(jfired, in_axes=(None, 0, 0, 0))
    rng = np.random.RandomState(4)
    fired = 0
    for st, _, _, _ in snaps:
        prev = st["stage_completions"]
        cur = prev + rng.randint(0, 2, prev.shape).astype(np.int32)
        want = np.asarray(vfired(jsh, jlt, prev, cur))
        got = tfired(sh, lt, torch.from_numpy(prev), torch.from_numpy(cur))
        np.testing.assert_array_equal(got.numpy(), want)
        fired += int(want.sum())
    assert fired > 0


def test_one_superstep_in_step_relink_matches_reference():
    """With chain tables and the relink IN the step (the reference's
    default ``defer_relink=False``), one port superstep equals the
    reference's leaf by leaf, ``heap_in`` rewritten by the hand-offs
    included."""
    kw, t, snaps = _captured("chain", defer=False)
    cfg = TConfig(**kw)
    sh, lt, _, _ = tables_from_numpy(t, "cpu")
    relinked = 0
    for k, (st, inbox, want_st, want_out) in enumerate(snaps):
        tst = state_from_numpy(st, cfg, "cpu")
        tin = TMailbox(**{f: _to_torch(v) for f, v in inbox.items()})
        got_st, _ = t_rank_superstep(cfg, sh, lt, tst, tin)
        _assert_leaves_equal(state_to_numpy(got_st), want_st,
                             f"in-step capture {k} state")
        relinked += int((want_st["heap_in"] != st["heap_in"]).any())
    assert relinked > 0         # the sweep saw in-step hand-off relinks


def _chain_body_states(n_steps=64):
    """The reference's daemon body (vmapped superstep + deferred per-edge
    relink + exchange + liveness) stepped from a launch prologue over a
    chained workload until the launch goes not-live: [(state, inbox,
    next_state, next_inbox)]."""
    cfg, kw, rt = _chain_workload()
    t = rt._tables
    sh, lt = jdaemon.shared_tables(t), jdaemon.local_tables(t)
    fwd, rev = jnp.asarray(t.fwd_src), jnp.asarray(t.rev_src)
    body = jax.jit(jdaemon._sim_body_fn(cfg, jdaemon._relink_edges(t)))
    st = jdaemon.launch_prologue(rt.queues.pack_sq(rt.state))
    inbox = jdaemon._load_mailbox(st)
    out = []
    for _ in range(n_steps):
        if not bool(st.global_live[0]):     # the reference's loop ends here
            break
        nst, ninbox = body(sh, lt, fwd, rev, st, inbox)
        out.append((_np_tree(st), _np_tree(inbox), _np_tree(nst),
                    _np_tree(ninbox)))
        st, inbox = nst, ninbox
    return kw, t, out


def test_sim_body_with_chains_matches_reference():
    """The daemon body with its deferred relink (static slices / gathers +
    ``where`` on ``fired``) equals the reference's body superstep by
    superstep, every leaf and the in-flight mailbox."""
    kw, t, states = _chain_body_states()
    cfg = TConfig(**kw)
    sh, lt, fwd, rev = tables_from_numpy(t, "cpu")
    body = tdaemon._sim_body_fn(
        cfg, tdaemon._edge_plan(tdaemon._relink_edges(t), "cpu"))
    relinked = 0
    for k, (st, inbox, want_st, want_in) in enumerate(states):
        tst = state_from_numpy(st, cfg, "cpu")
        tin = TMailbox(**{f: _to_torch(v) for f, v in inbox.items()})
        got_st, got_in = body(sh, lt, fwd, rev, tst, tin)
        _assert_leaves_equal(state_to_numpy(got_st), want_st,
                             f"body step {k}")
        for f, v in want_in.items():
            np.testing.assert_array_equal(_bits(_np_tree(got_in)[f]),
                                          _bits(v), err_msg=f)
        relinked += int((want_st["heap_in"] != st["heap_in"]).any())
    assert relinked > 0


def test_gated_chain_body_leaves_heap_in_unchanged():
    """A gated (not-live) body on chain tables changes no leaf — heap_in
    included — even in supersteps where, live, a chained stage completes
    and the relink rewrites heap_in."""
    kw, t, states = _chain_body_states()
    cfg = TConfig(**kw)
    sh, lt, fwd, rev = tables_from_numpy(t, "cpu")
    body = tdaemon._sim_body_fn(
        cfg, tdaemon._edge_plan(tdaemon._relink_edges(t), "cpu"))
    checked = 0
    for st, inbox, want_st, _ in states:
        if not (want_st["heap_in"] != st["heap_in"]).any():
            continue
        tst = state_from_numpy(st, cfg, "cpu")
        tst = tst._replace(global_live=torch.zeros_like(tst.global_live))
        before = state_to_numpy(tst)
        tin = TMailbox(**{f: _to_torch(v) for f, v in inbox.items()})
        got, _ = body(sh, lt, fwd, rev, tst, tin)
        _assert_leaves_equal(state_to_numpy(got), before, "gated body")
        checked += 1
    assert checked > 0
