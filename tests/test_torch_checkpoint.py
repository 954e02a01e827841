"""The port's checkpoints and fault-tolerant train loop against the
reference.

``tests/test_substrates.py``'s checkpoint and controller tests on the port
(round trip and retention, corruption, the async writer, recovery from an
injected failure with bitwise replayed losses), then the two packages on
one checkpoint directory: every file a checkpoint holds is byte for byte
the same whichever package wrote it, and each package restores the
other's bit for bit.  bfloat16 leaves: the port restores the reference's
and writes the same bytes; the reference's own ``restore`` cannot load
them (``jnp.asarray`` of numpy's ``V2`` records raises ``TypeError``), a
reference-side divergence the last test pins.  Finally
``launch/train.py``'s default path on the CPU, then ``--resume``.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as JC
import repro_torch.checkpoint.ckpt as TC
from repro.configs import get_config as jget
from repro.train.state import init_state as jinit
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.fabric.ft import FTConfig, TrainController
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import init_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_leaves_with_path
from torch_parity import bits, one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = ShapeCell("t", 32, 4, "train")
ARCH = "qwen3-0.6b"
CFG = get_config(ARCH).reduced()


def tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return bits(t.numpy())


def assert_trees_bit_equal(a, b) -> None:
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(tbits(x), tbits(y))


def files(step_dir: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}


# ---------------------------------------------------------------------------
# tests/test_substrates.py's checkpoint tests on the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    state = init_state(CFG, device="cpu")
    for s in (0, 10, 20, 30):
        save(tmp_path, s, state, extras={"x": s}, keep=2)
    assert latest_step(tmp_path) == 30
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_20", "step_30"]
    got, extras = restore(tmp_path, 30, state)
    assert extras["x"] == 30
    assert type(got) is type(state)
    assert_trees_bit_equal(got, state)


def test_checkpoint_corruption_detected(tmp_path):
    state = init_state(CFG, device="cpu")
    path = save(tmp_path, 0, state)
    victim = next(path.glob("*.npy"))
    arr = np.load(victim).copy()
    arr.reshape(-1)[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError):
        restore(tmp_path, 0, state)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    state = init_state(CFG, device="cpu")
    ck.save_async(5, state)
    # The host copy is taken before the writer starts: an in-place update
    # of the state now cannot reach the checkpoint.
    want = [x.clone() for x in tree_leaves(state)]
    for x in tree_leaves(state):
        x.add_(1)
    ck.wait()
    assert latest_step(tmp_path) == 5
    got, _ = restore(tmp_path, 5, state)
    for x, y in zip(tree_leaves(got), want):
        np.testing.assert_array_equal(tbits(x), tbits(y))


def test_controller_recovers_from_injected_failure(tmp_path):
    state = init_state(CFG, device="cpu")
    pipe = SyntheticPipeline(CFG, CELL)
    step_fn = make_train_step(CFG, AdamWConfig(lr=1e-3))
    ctrl = TrainController(
        FTConfig(ckpt_dir=str(tmp_path), ckpt_period=4, max_restarts=2),
        step_fn, state, pipe, inject_failure_at=6)
    logs = ctrl.run(10)
    assert ctrl.restarts == 1
    assert int(ctrl.state.step) == 10
    steps = [m["step"] for m in logs]
    assert steps == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9]  # replayed 4, 5
    # losses replayed from the checkpoint are bitwise identical
    by_step = {}
    replays = 0
    for m in logs:
        if m["step"] in by_step:
            assert m["loss"] == by_step[m["step"]]
            replays += 1
        by_step[m["step"]] = m["loss"]
    assert replays == 2
    assert all(np.isfinite(m["loss"]) for m in logs)


# ---------------------------------------------------------------------------
# one checkpoint, two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    return jinit(jget(ARCH).reduced())


def test_keys_are_the_reference_keys(jax_state):
    jkeys = list(JC._flatten(jax_state))
    tkeys = [k for k, _ in tree_leaves_with_path(
        init_state(CFG, device="meta"))]
    assert tkeys == jkeys
    assert len(jkeys) == 43
    assert jkeys[0] == ".params/embed" and jkeys[-1] == ".step"


def test_reference_checkpoint_restores_in_the_port(tmp_path, jax_state):
    JC.save(tmp_path, 7, jax_state, extras={"pipeline": {"step": 7}})
    got, extras = restore(tmp_path, 7, init_state(CFG, device="cpu"))
    assert extras == {"pipeline": {"step": 7}}
    jl = jax.tree_util.tree_leaves(jax_state)
    tl = tree_leaves(got)
    assert len(jl) == len(tl) == 43
    for a, b in zip(jl, tl):
        assert str(np.asarray(a).dtype) == str(b.dtype).replace("torch.",
                                                                "")
        np.testing.assert_array_equal(tbits(b), bits(np.asarray(a)))


def test_port_checkpoint_restores_in_the_reference(tmp_path, jax_state):
    ts = train_state_from_numpy(
        *(jax.tree_util.tree_map(np.asarray, x) for x in jax_state),
        device="cpu")
    save(tmp_path / "port", 7, ts, extras={"x": 1})
    JC.save(tmp_path / "ref", 7, jax_state, extras={"x": 1})
    # Same files, byte for byte: manifest (keys, files, shapes, dtypes,
    # crc32), extras and every leaf's .npy.
    tf, jf = files(tmp_path / "port" / "step_7"), files(
        tmp_path / "ref" / "step_7")
    assert tf.keys() == jf.keys() and len(tf) == 45
    for name in jf:
        assert tf[name] == jf[name], name
    got, extras = JC.restore(tmp_path / "port", 7, jax_state)
    assert extras == {"x": 1}
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jax_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bfloat16_leaves_both_ways(tmp_path):
    rng = np.random.RandomState(3)
    jtree = {"w": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
             "n": {"s": jnp.asarray(rng.randn(7), jnp.bfloat16)},
             "step": jnp.zeros((), jnp.int32)}
    ttree = {"w": torch.from_numpy(np.asarray(jtree["w"]).view(np.int16)
                                   .copy()).view(torch.bfloat16),
             "n": {"s": torch.from_numpy(np.asarray(jtree["n"]["s"])
                                         .view(np.int16).copy())
                   .view(torch.bfloat16)},
             "step": torch.zeros((), dtype=torch.int32)}
    JC.save(tmp_path / "ref", 1, jtree)
    save(tmp_path / "port", 1, ttree)
    tf, jf = files(tmp_path / "port" / "step_1"), files(
        tmp_path / "ref" / "step_1")
    assert tf == jf
    assert b"'descr': '<V2'" in jf["w.npy"]
    for d in ("ref", "port"):
        got, _ = restore(tmp_path / d, 1, ttree)
        assert got["w"].dtype == torch.bfloat16
        assert_trees_bit_equal(got, ttree)
        # Reference-side divergence: JAX cannot load its own bf16 leaves.
        with pytest.raises(TypeError, match="V2"):
            JC.restore(tmp_path / d, 1, jtree)


# ---------------------------------------------------------------------------
# launch/train.py's default path on the CPU, then --resume
# ---------------------------------------------------------------------------

def test_launch_train_default_path_then_resume(tmp_path, monkeypatch):
    common = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-period", "2"]
    first = launch_train.main(common + ["--steps", "4"])
    assert [m["step"] for m in first.metrics_log] == [0, 1, 2, 3]
    assert latest_step(tmp_path / "ckpt") == 4

    restored = {}

    def spy(*a, _restore=TC.restore, **kw):
        tree, extras = _restore(*a, **kw)
        restored["state"] = [x.clone() for x in tree_leaves(tree)]
        restored["extras"] = extras
        return tree, extras

    monkeypatch.setattr(TC, "restore", spy)
    resumed = launch_train.main(common + ["--steps", "6", "--resume"])
    monkeypatch.undo()
    assert restored["extras"]["pipeline"]["step"] == 4
    for x, y in zip(restored["state"], tree_leaves(first.state)):
        np.testing.assert_array_equal(tbits(x), tbits(y))
    assert [m["step"] for m in resumed.metrics_log] == [4, 5]
    assert int(resumed.state.step) == 6 and latest_step(
        tmp_path / "ckpt") == 6
    # An uninterrupted run of 6 steps reads the same losses, bit for bit.
    straight = launch_train.main(
        common[:-4] + ["--ckpt-dir", str(tmp_path / "straight"),
                       "--ckpt-period", "2", "--steps", "6"])
    assert [m["loss"] for m in straight.metrics_log[4:]] == [
        m["loss"] for m in resumed.metrics_log]
    assert_trees_bit_equal(straight.state, resumed.state)


def test_train_default_phase_at_reduced_size(tmp_path):
    """``chip_smoke.py`` phase 7i's function on the CPU (qwen3-0.6b
    ``.reduced()``, batch 4, seq 16): the failure at step 6 restores step
    4, both replayed losses are bitwise their first run's, and
    ``--resume`` restores the controller's final state bit for bit."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    res = cs.train_default("cpu", dict(cs.TRAIN_DEFAULT, reduced=True,
                                       batch=4, seq=16), tmp_path)
    assert res["steps"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert res["replay_bitwise"] == [True, True]
    assert res["resume"]["bit_equal"] and res["resumed_steps"] == [8, 9]
    # saves: 0, 4, 8 and the final 8 in the loop; 8, 10 and 10 on resume
    assert res["saves"] == 7
    assert not list(tmp_path.iterdir())     # the directory is removed
