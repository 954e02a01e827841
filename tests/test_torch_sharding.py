"""The port's sharding layer against the reference's.

``repro_torch.parallel.sharding``, ``optim.adamw.zero1_pspecs``,
``train.state.state_pspecs`` and ``models.io.input_specs`` give the
reference's spec and shape for every leaf of every arch at full size (the
port on ``meta``, the reference through ``jax.eval_shape``), on both
production meshes' axis names; the per-device argument bytes each package
reckons from its own specs agree for every (arch, cell).  Then the
placement mesh: ``device_put`` and a gather round-trip uneven and
two-axis specs, and the reference's elastic reshard
(``tests/test_meshbackend.py::test_elastic_checkpoint_reshard``) on the
port: save from 4x2, restore onto 2x2 over 8 x ``cpu``, with checkpoints
crossing between the packages and the chunk order of a dim sharded over
("data", "model") held to JAX's ``addressable_shards``.  The models'
sharding hooks change no eager result.
"""
import functools
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.parallel.sharding as JS
from repro.configs import _REGISTRY
from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.models import input_specs as jinput_specs
from repro.train.state import abstract_state as jabstract
from repro.train.state import state_pspecs as jstate_pspecs
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import spec_argument_bytes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model, input_specs
from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           ShardedTensor, batch_pspecs,
                                           device_put, param_pspecs,
                                           placements)
from repro_torch.train.state import (abstract_state, init_state,
                                     state_pspecs, state_shardings)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path,
                              tree_unflatten)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(_REGISTRY)
CELLS = [(a, c) for a in ARCHS for c in get_config(a).cells()]
AXES = {"16x16": ("data", "model"), "2x16x16": ("pod", "data", "model")}
CPU = torch.device("cpu")


def cpu_mesh(shape, names) -> Mesh:
    devs = np.empty(shape, dtype=object)
    devs.reshape(-1)[:] = [CPU] * math.prod(shape)
    return Mesh(devs, names)


MESHES = {"16x16": cpu_mesh((16, 16), AXES["16x16"]),
          "2x16x16": cpu_mesh((2, 16, 16), AXES["2x16x16"])}


def jflat(tree) -> dict:
    """The reference's tree keyed as its checkpoints key it, specs as
    leaves."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def assert_specs_equal(jtree, ttree) -> None:
    want = {k: tuple(v) for k, v in jflat(jtree).items()}
    got = {k: tuple(v) for k, v in tree_leaves_with_path(ttree)}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_state_pspecs_equal_reference(arch):
    """param_pspecs, and state_pspecs with ZeRO-1 at data sizes 16 and 4,
    leaf for leaf at full size."""
    jc, tc = jget(arch), get_config(arch)
    jst = jstate(arch)
    tst = abstract_state(tc)
    assert_specs_equal(JS.param_pspecs(jst.params), param_pspecs(tst.params))
    for data in (16, 4):
        assert_specs_equal(jstate_pspecs(jc, jst, data),
                           state_pspecs(tc, tst, data))


@pytest.mark.parametrize("mesh", sorted(AXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_batch_specs_equal_reference(arch, mesh):
    """input_specs (shape, dtype) and batch_pspecs / _cache_spec for every
    cell of the arch; the reference's batch_pspecs reads only the mesh's
    axis names."""
    jmesh = types.SimpleNamespace(axis_names=AXES[mesh])
    for cell in get_config(arch).cells():
        js = jinput_specs(jget(arch), JSHAPES[cell])
        ts = input_specs(get_config(arch), SHAPES[cell])
        jl, tl = jflat(js), dict(tree_leaves_with_path(ts))
        assert jl.keys() == tl.keys(), cell
        for k in jl:
            assert tuple(jl[k].shape) == tl[k].shape, (cell, k)
            assert str(jl[k].dtype) == str(tl[k].dtype).replace(
                "torch.", ""), (cell, k)
        assert_specs_equal(JS.batch_pspecs(jmesh, js),
                           batch_pspecs(MESHES[mesh], ts))


@functools.lru_cache(maxsize=None)
def jstate(arch: str):
    return jax.eval_shape(lambda: jabstract(jget(arch)))


@functools.lru_cache(maxsize=None)
def jparams(arch: str):
    from repro.models import build_model as jbuild
    return jax.eval_shape(lambda: jbuild(jget(arch)).init(0))


def reference_argument_bytes(arch: str, cell: str, mesh: str) -> int:
    """The reference's per-device argument bytes reckoned from its own
    specs: each leaf's largest shard, ``prod(ceil(dim / shards))`` times
    its itemsize."""
    sizes = dict(zip(AXES[mesh], MESHES[mesh].devices.shape))
    jmesh = types.SimpleNamespace(axis_names=AXES[mesh])
    cfg, c = jget(arch), JSHAPES[cell]
    specs = jinput_specs(cfg, c)
    bspecs = JS.batch_pspecs(jmesh, specs)
    if c.kind == "train":
        st = jstate(arch)
        trees = [(st, jstate_pspecs(cfg, st, sizes["data"])),
                 (specs, bspecs)]
    else:
        params = jparams(arch)
        trees = [(params, JS.param_pspecs(params))]
        if c.kind == "prefill":
            trees.append((specs, bspecs))
        else:
            tok = JP(JS.data_axes(jmesh)) if c.global_batch > 1 \
                else JP(None)
            trees += [(specs["cache"], bspecs["cache"]),
                      (specs["tokens"], tok)]
    total = 0
    for values, pspecs in trees:
        v, s = jflat(values), jflat(pspecs)
        for k, leaf in v.items():
            spec = list(s[k]) + [None] * (leaf.ndim - len(s[k]))
            n = 1
            for dim, e in zip(leaf.shape, spec):
                axes = () if e is None else (e,) if isinstance(e, str) \
                    else e
                n *= -(-dim // math.prod(sizes[a] for a in axes))
            total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", sorted(AXES))
@pytest.mark.parametrize("arch,cell", CELLS)
def test_argument_bytes_equal_reference(arch, cell, mesh):
    got = spec_argument_bytes(get_config(arch), SHAPES[cell], MESHES[mesh])
    assert got == reference_argument_bytes(arch, cell, mesh)


# ---------------------------------------------------------------------------
# the placement mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,spec", [
    ((10, 7), P("data", "model")),           # uneven on both
    ((5, 3), P(("data", "model"))),          # 5 over 8 positions
    ((16, 6, 4), P(None, ("data", "model"))),
    ((9,), P()),
    ((6, 8), P("model", "data")),
])
def test_device_put_gather_round_trip(shape, spec):
    mesh = cpu_mesh((4, 2), ("data", "model"))
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g)
    st = device_put(x, NamedSharding(mesh, spec))
    assert isinstance(st, ShardedTensor)
    assert torch.equal(st.gather(), x)
    assert len(st.sharding.device_set) == 8
    # each position holds its own chunk (ceil-sized, the last one short)
    big = NamedSharding(mesh, spec).shard_shape(shape)
    for pos, idx, t in st.addressable_shards:
        assert torch.equal(t, x[idx])
        assert all(a <= b for a, b in zip(t.shape, big))


def test_host_mesh_follows_the_reference_split():
    m = make_host_mesh(devices=[CPU] * 8)
    assert m.shape == {"data": 4, "model": 2}
    assert make_host_mesh(devices=[CPU] * 3).shape == {"data": 3, "model": 1}
    assert make_host_mesh(4, devices=[CPU] * 8).shape == \
        {"data": 2, "model": 4}


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_placement_mesh_raises_without_a_card():
    with pytest.raises(RuntimeError):
        make_host_mesh()
    with pytest.raises(RuntimeError):
        Mesh(np.array([torch.device("cuda")], dtype=object), ("data",))


_REFERENCE_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys, zlib
    sys.path.insert(0, "@SRC@")
    import numpy as np, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.train.state import init_state, state_shardings
    from repro.checkpoint.ckpt import save, restore

    ref_dir, port_dir = sys.argv[1], sys.argv[2]
    crc = lambda a: zlib.crc32(np.ascontiguousarray(np.asarray(a))) \\
        & 0xFFFFFFFF
    cfg = get_config("qwen3-0.6b").reduced()
    state = init_state(cfg)
    mesh8 = jax.make_mesh((4, 2), ("data", "model"))
    st8 = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, s), state,
        state_shardings(mesh8, cfg, state))
    save(ref_dir, 0, st8)
    mesh4 = jax.make_mesh((2, 2), ("data", "model"))
    got, _ = restore(port_dir, 0, state,
                     shardings=state_shardings(mesh4, cfg, state))
    x = jax.device_put(np.arange(16 * 3).reshape(16, 3),
                       NamedSharding(mesh8, P(("data", "model"))))
    idx = {s.device: s.index[0] for s in x.addressable_shards}
    chunks = [[idx[d].start, idx[d].stop] for d in mesh8.devices.flat]
    print(json.dumps({
        "saved": [crc(a) for a in jax.tree_util.tree_leaves(state)],
        "restored": [crc(a) for a in jax.tree_util.tree_leaves(got)],
        "shard_count": len(jax.tree_util.tree_leaves(
            got)[1].sharding.device_set),
        "chunks": chunks}))
""").replace("@SRC@", str(ROOT / "src"))


def crcs(tree) -> list:
    import zlib

    out = []
    for t in tree_leaves(tree):
        t = t.gather() if isinstance(t, ShardedTensor) else t
        out.append(zlib.crc32(t.detach().contiguous().numpy()) & 0xFFFFFFFF)
    return out


def test_elastic_checkpoint_reshard():
    """Save reduced qwen3-0.6b from a 4x2 placement mesh of 8 x cpu,
    restore onto 2x2: every gathered leaf bit-equal, the reference's shard
    count (4).  The reference restores the port's checkpoint onto its 2x2
    mesh bit-equal, the port restores the reference's, and the chunk
    order of a dim sharded over ("data", "model") is JAX's."""
    cfg = get_config("qwen3-0.6b").reduced()
    state = init_state(cfg, device="cpu")
    mesh8 = make_host_mesh(devices=[CPU] * 8)
    st8 = [device_put(a, s) for a, s in zip(
        tree_leaves(state), tree_leaves(state_shardings(mesh8, cfg, state)))]
    with tempfile.TemporaryDirectory() as d:
        port_dir, ref_dir = pathlib.Path(d, "port"), pathlib.Path(d, "ref")
        save(port_dir, 0, tree_unflatten(state, st8))
        mesh4 = make_host_mesh(devices=[CPU] * 4)
        sh4 = state_shardings(mesh4, cfg, state)
        got, _ = restore(port_dir, 0, state, shardings=sh4)
        assert all(isinstance(t, ShardedTensor) for t in tree_leaves(got))
        assert crcs(got) == crcs(state)
        shard_count = len(tree_leaves(got)[1].sharding.device_set)
        assert shard_count == 4

        r = subprocess.run([sys.executable, "-c", _REFERENCE_SIDE,
                            str(ref_dir), str(port_dir)],
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        ref = json.loads(r.stdout.strip().splitlines()[-1])
        assert ref["shard_count"] == shard_count
        assert ref["restored"] == crcs(state)       # the port's, in JAX
        mine, _ = restore(ref_dir, 0, state, shardings=sh4)
        assert crcs(mine) == ref["saved"]           # the reference's, here
    # dim 0 over ("data", "model"): the placement mesh's chunks and
    # DTensor's, position by position (row-major), are JAX's
    sharding = NamedSharding(mesh8, P(("data", "model")))
    x = device_put(torch.arange(16 * 3).reshape(16, 3), sharding)
    assert [[i[0].start, i[0].stop] for _, i, _ in x.addressable_shards] \
        == ref["chunks"]
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset
    got = []
    for pos in mesh8.positions():
        shape, offset = _compute_local_shape_and_global_offset(
            (16, 3), (4, 2), list(pos), placements(sharding.spec, mesh8, 2))
        got.append([offset[0], offset[0] + shape[0]])
    assert got == ref["chunks"]


# ---------------------------------------------------------------------------
# the models' sharding hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,env", [
    ("deepseek-moe-16b", "REPRO_MOE_EP"),
    ("deepseek-moe-16b", "REPRO_MOE_CAP_SHARD"),
    ("kimi-k2-1t-a32b", "REPRO_MOE_EP"),
    ("mamba2-2.7b", "REPRO_SSM_SHARD_HEADS"),
    ("zamba2-1.2b", "REPRO_SSM_SHARD_HEADS"),
])
def test_sharding_hooks_leave_eager_results_unchanged(monkeypatch, arch,
                                                      env):
    """With a hook's variable set, an eager CPU loss and its gradients are
    bit-equal to the same without it (no mesh, no constraint)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    rng = np.random.RandomState(3)
    batch = {"tokens": torch.from_numpy(rng.randint(0, 256, (2, 16))
                                        .astype(np.int32)),
             "targets": torch.from_numpy(rng.randint(0, 256, (2, 16))
                                         .astype(np.int32))}

    def run():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = model.loss_fn(tree_unflatten(params, leaves), batch)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    monkeypatch.delenv("REPRO_MOE_EP", raising=False)
    monkeypatch.delenv("REPRO_MOE_CAP_SHARD", raising=False)
    monkeypatch.delenv("REPRO_SSM_SHARD_HEADS", raising=False)
    want = run()
    monkeypatch.setenv(env, "1")
    if env == "REPRO_MOE_CAP_SHARD":
        monkeypatch.setenv("REPRO_MOE_EP", "1")
    got = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "paligemma-3b",
                                  "seamless-m4t-large-v2", "zamba2-1.2b"])
def test_make_concrete_equals_reference(arch, kind):
    """make_concrete draws the reference's values, leaf for leaf, from
    one numpy stream in the reference's leaf order."""
    from repro.configs.base import ShapeCell as JCell
    from repro.models import make_concrete as jconcrete
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import make_concrete

    jc, tc = jget(arch).reduced(), get_config(arch).reduced()
    want = jflat(jconcrete(jinput_specs(jc, JCell("t", 16, 2, kind)),
                           seed=5, vocab=jc.vocab))
    got = dict(tree_leaves_with_path(make_concrete(
        input_specs(tc, ShapeCell("t", 16, 2, kind)), seed=5,
        vocab=tc.vocab, device="cpu")))
    assert want.keys() == got.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k]
        assert str(w.dtype) == str(g.dtype).replace("torch.", ""), k
        if g.is_floating_point():
            w, g = w.astype(np.float32), g.float()
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
