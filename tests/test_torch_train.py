"""OCCL data-parallel training on the port against the reference.

* The ``OcclGradSync`` bucket structure (leaf ids, sizes, totals,
  collective ids) and the runtime config it derives equal the reference's,
  for full-size ViT-Base (shapes only: ``jax.eval_shape`` against the meta
  device) and for reduced qwen3.
* ``all_reduce`` on identical numpy gradients is bit-equal to the
  reference's, for the flat ring, ``two_level`` and ``compress_wire``,
  outputs and superstep counters.
* The overlapped grads step (``make_overlap_grads_step``) returns averaged
  gradients within ``rtol=1e-4, atol=1e-6`` of ``static_all_reduce`` (as
  ``tests/test_occl_sync.py`` holds the reference), hides supersteps
  behind the backward pass and completes every bucket once per rank.
* The record's dense grad-sync cell (``BENCH_collectives.json`` ->
  ``training.dense``) gives exactly its superstep and tick-call counts.
* ``python -m repro_torch.launch.train --occl-sync`` runs on the CPU.
"""
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.train.occl_sync import OcclGradSync as JSync
from repro.train.state import init_state as jinit
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch import train as launch
from repro_torch.train.occl_sync import OcclGradSync, static_all_reduce
from repro_torch.train.state import init_state
from repro_torch.train.step import make_grads_step, make_overlap_grads_step
from repro_torch.tree import tree_leaves, tree_unflatten
from torch_parity import bits, one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

ROOT = pathlib.Path(__file__).resolve().parent.parent
DENSE = json.loads((ROOT / "BENCH_collectives.json").read_text())[
    "training"]["dense"]
COUNTS = ("supersteps", "preempts", "stage_completions", "completed",
          "slices_moved", "tick_calls", "barrier_supersteps")


def templates(arch: str, reduced: bool):
    jc, tc = jget(arch), tget(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    return (jax.eval_shape(lambda: jinit(jc).params),
            init_state(tc, device="meta").params)


def both_syncs(arch, reduced, n_ranks, **kw):
    jt, tt = templates(arch, reduced)
    return JSync(jt, n_ranks, **kw), OcclGradSync(tt, n_ranks, device="cpu",
                                                   **kw)


@pytest.mark.parametrize("arch,reduced,kw", [
    ("vit-base", False, dict(bucket_elems=6_553_600, slice_elems=1024,
                             burst_slices=8)),
    ("vit-base", False, dict()),
    ("qwen3-0.6b", True, dict(bucket_elems=16384, slice_elems=512,
                              burst_slices=8, bandwidth_groups=2,
                              intra_burst_cap=8, inter_burst_cap=2)),
    ("qwen3-0.6b", True, dict(bucket_elems=2048, hierarchy=(2, 2))),
])
def test_bucket_structure_equals_reference(arch, reduced, kw):
    js, ts = both_syncs(arch, reduced, 4, **kw)
    assert len(ts.buckets) == len(js.buckets) > 1
    for jb, tb in zip(js.buckets, ts.buckets):
        assert tb.leaf_ids == jb.leaf_ids
        assert tb.sizes == jb.sizes
        assert tb.total == jb.total
        assert int(tb.coll_id) == int(jb.coll_id)
    assert ts.shapes == [tuple(s) for s in js.shapes]
    for f in ("n_ranks", "max_colls", "max_comms", "slice_elems",
              "conn_depth", "burst_slices", "heap_elems", "sq_len",
              "superstep_budget", "dtype"):
        assert getattr(ts.occl.cfg, f) == getattr(js.occl.cfg, f), f
    if arch == "vit-base" and "bucket_elems" in kw:
        assert sum(b.total for b in ts.buckets) == 86_535_936
        assert ts.occl.cfg.heap_elems == 692_308_224


def numpy_grads(tmpl, n_ranks, seed):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*l.shape).astype(np.float32)
             for l in tree_leaves(tmpl)] for _ in range(n_ranks)]


@pytest.mark.parametrize("n_ranks,kw", [
    (2, dict(bucket_elems=8192)),
    (4, dict(bucket_elems=65536, slice_elems=1024, hierarchy=(2, 2))),
    (2, dict(bucket_elems=8192, compress_wire=True)),
    (4, dict(bucket_elems=16384, slice_elems=512, burst_slices=8,
             bandwidth_groups=2, intra_burst_cap=8, inter_burst_cap=2)),
])
def test_all_reduce_bit_equal_to_reference(n_ranks, kw):
    js, ts = both_syncs("qwen3-0.6b", True, n_ranks, **kw)
    jt, tt = templates("qwen3-0.6b", True)
    flat = numpy_grads(tt, n_ranks, 7)
    jtree = jax.tree_util.tree_structure(jt)
    jgot = js.all_reduce([jax.tree_util.tree_unflatten(jtree, g)
                          for g in flat])
    tgot = ts.all_reduce([tree_unflatten(tt, g) for g in flat])
    for r in range(n_ranks):
        for a, b in zip(jax.tree_util.tree_leaves(jgot[r]),
                        tree_leaves(tgot[r])):
            np.testing.assert_array_equal(bits(b.numpy()),
                                          bits(np.asarray(a)))
    jst, tst = js.stats(), ts.stats()
    for k in COUNTS:
        np.testing.assert_array_equal(tst[k], np.asarray(jst[k]), err_msg=k)
    assert tst["chains"] == jst["chains"]
    assert int(tst["completed"].sum()) == int(jst["completed"].sum())
    # within tolerance of the static average (bf16 wire: bf16 tolerance)
    want = static_all_reduce([tree_unflatten(tt, [torch.from_numpy(x)
                                                  for x in g]) for g in flat])
    tol = dict(rtol=2e-2, atol=1e-2) if kw.get("compress_wire") \
        else dict(rtol=1e-4, atol=1e-6)
    for a, b in zip(tree_leaves(tgot[0]), tree_leaves(want[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)


def dense_cell(dp, batch, seq, **kw):
    cfg = tget("qwen3-0.6b").reduced()
    cell = ShapeCell("t", seq, batch, "train")
    states = [init_state(cfg, device="cpu") for _ in range(dp)]
    batches = [SyntheticPipeline(cfg, cell, shard_id=r,
                                 n_shards=dp).batch_at(0) for r in range(dp)]
    sync = OcclGradSync(init_state(cfg, device="meta").params, dp,
                        device="cpu", **kw)
    return cfg, states, batches, sync


def deltas(s0, s1) -> dict:
    d = lambda k: int(np.max(s1[k] - s0[k]))
    return {"supersteps": d("supersteps"),
            "exposed_supersteps": d("barrier_supersteps"),
            "hidden_supersteps": d("overlap_supersteps"),
            "tick_calls": d("tick_calls")}


def test_overlap_step_matches_static():
    dp = 2
    cfg, states, batches, sync = dense_cell(dp, dp, 16, bucket_elems=16384,
                                            slice_elems=512)
    gfn = make_grads_step(cfg)
    per_rank = [gfn(states[r], batches[r])[1] for r in range(dp)]
    step = make_overlap_grads_step(cfg, sync, ticks_per_boundary=4)
    s0 = sync.stats()
    st, losses, got = step(sync.occl.state, [s.params for s in states],
                           batches)
    sync.occl.adopt_state(st)
    s1 = sync.stats()
    want = static_all_reduce(per_rank)
    for r in range(dp):
        for a, b in zip(tree_leaves(got[r]), tree_leaves(want[r])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6)
    for r in range(dp):
        np.testing.assert_allclose(
            float(losses[r]), float(gfn(states[r], batches[r])[0]), rtol=0)
    d = deltas(s0, s1)
    assert d["hidden_supersteps"] > 0
    assert d["hidden_supersteps"] + d["exposed_supersteps"] \
        == d["supersteps"]
    assert int((s1["completed"] - s0["completed"]).sum()) \
        == dp * len(sync.buckets)
    # host reconciliation stays consistent after adopt_state
    assert sync.occl.queues.outstanding() == 0


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_record_dense_cell_counts():
    """BENCH_collectives.json training.dense through ``chip_smoke.py``'s
    own scenario (the card runs the same function): the overlap step, then
    the barrier step, on one sync; counts are structural."""
    cs = _smoke()
    c = DENSE["config"]
    assert (cs.DENSE_RECORD["dp"], cs.DENSE_RECORD["batch"],
            cs.DENSE_RECORD["seq"], cs.DENSE_RECORD["ticks_per_boundary"]) \
        == (c["dp"], c["batch"], c["seq"], c["ticks_per_boundary"])
    for k in ("burst_slices", "bandwidth_groups", "intra_burst_cap",
              "inter_burst_cap"):
        assert cs.DENSE_RECORD["sync"][k] == c[k], k
    got = cs.dense_record("cpu")
    assert got["buckets"] == c["buckets"]
    for mode in ("overlap", "barrier"):
        for k in ("supersteps", "exposed_supersteps", "hidden_supersteps",
                  "tick_calls"):
            assert got[mode][k] == DENSE[mode][k] == cs.DENSE_STEPS[mode][k], \
                (mode, k, got[mode])
        np.testing.assert_allclose(got[mode]["loss_mean"],
                                   DENSE[mode]["loss_mean"], rtol=1e-2)
    assert (got["barrier"]["supersteps"], got["barrier"]["tick_calls"]) \
        == (196, 41)
    assert (got["overlap"]["supersteps"], got["overlap"]["exposed_supersteps"],
            got["overlap"]["hidden_supersteps"],
            got["overlap"]["tick_calls"]) == (244, 20, 224, 30)


def test_chip_smoke_vit_cell_matches_the_sync_it_builds():
    """The burst shape and heap ``chip_smoke.py`` checks the kernel at are
    the ViT cell's runtime (built on the meta template, no allocation)."""
    cs = _smoke()
    v = cs.VIT
    sync = OcclGradSync(templates("vit-base", False)[1], v["dp"],
                        bucket_elems=v["bucket_elems"],
                        slice_elems=v["slice_elems"],
                        burst_slices=v["burst_slices"], device="cpu")
    c = sync.occl.cfg
    assert (c.n_ranks, c.max_colls, c.conn_depth, c.heap_elems) \
        == tuple(cs.VIT_RUNTIME.values())
    assert cs.BURST_SHAPES[-1] == (
        "vit", c.n_ranks, c.max_comms, c.burst_slices, c.slice_elems,
        c.max_colls, c.conn_depth, c.heap_elems)
    assert c.n_ranks * (c.heap_elems + c.burst_slices * c.slice_elems) \
        > 2 ** 31


def test_launch_train_occl_sync_on_cpu(capsys):
    out = launch.main(["--arch", "vit-base", "--reduced", "--occl-sync",
                       "--dp", "2", "--batch", "4", "--steps", "2",
                       "--device", "cpu"])
    assert [r["step"] for r in out["log"]] == [0, 1]
    assert all(r["supersteps"] > 0 and np.isfinite(r["loss"])
               for r in out["log"])
    assert all(int(s.step) == 2 for s in out["states"])
    # identical seeds and averaged grads keep the replicas identical
    for a, b in zip(tree_leaves(out["states"][0].params),
                    tree_leaves(out["states"][1].params)):
        assert torch.equal(a, b)
    assert "occl grad-sync: supersteps" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="TrainController"):
        launch.main(["--arch", "vit-base", "--reduced", "--device", "cpu"])


def test_grad_sync_evict_keeps_averaging():
    """``evict`` shrinks the sync and its buckets keep all-reducing."""
    _, ts = both_syncs("qwen3-0.6b", True, 4, bucket_elems=4096)
    _, tt = templates("qwen3-0.6b", True)
    ts.evict(3)
    assert ts.n_ranks == 3
    flat = numpy_grads(tt, 3, 1)
    got = ts.all_reduce([tree_unflatten(tt, g) for g in flat])
    for i, a in enumerate(tree_leaves(got[2])):
        want = (flat[0][i] + flat[1][i] + flat[2][i]) / 3
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-5, atol=1e-6)
