"""Port host registration layer: tables, config validation, guards.

* For every CollKind x R in 2..8 x root, the port's ``build_tables`` equals
  the reference's field by field (two communicators on two lanes, float32
  and bfloat16 heaps).
* ``OcclConfig`` rejects the same invalid inputs as the reference.
* Guards: no module of the port (nor ``chip_smoke.py``) imports ``jax`` or
  ``repro``; the runtime refuses to start without a card unless asked for
  the CPU.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import primitives as jprim
from repro.core import tables as jtables
from repro_torch.core import config as tconfig
from repro_torch.core import primitives as tprim
from repro_torch.core import tables as ttables
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = list(jprim.CollKind)


def _specs(P, cfg, R, root, rng_seed):
    """Every kind on a full-world ring (lane 0) and on a sub-ring of the
    last R-1 ranks (lane 1), registered exactly as the runtime does."""
    rng = np.random.RandomState(rng_seed)
    comms = [P.Communicator(0, tuple(range(R)), 0),
             P.Communicator(1, tuple(range(1, R)), 1)]
    specs, in_ptr, out_ptr = [], 0, 0
    for comm in comms:
        for kind in P.CollKind:
            n = int(rng.randint(1, 200))
            gs = comm.size
            if kind == P.CollKind.ALL_TO_ALL:
                n = gs * max(1, n // gs)
            ns, rounds = P.derive_slicing(n, gs, cfg.slice_elems,
                                          cfg.conn_depth)
            chunk = rounds * ns * cfg.slice_elems
            inc, outc = P.io_chunked(kind)
            sizes = ()
            if kind == P.CollKind.ALL_TO_ALL_RAGGED:
                cl = -(-n // gs)
                sizes = tuple(int(z) for z in rng.randint(0, cl + 1, gs))
            specs.append(P.CollectiveSpec(
                coll_id=len(specs), kind=kind, comm=comm, n_elems=n,
                op=int(rng.randint(0, 4)), root=root % gs, in_off=in_ptr,
                out_off=out_ptr, n_slices=ns, n_rounds=rounds,
                chunk_sizes=sizes))
            in_ptr += gs * chunk if inc else chunk
            out_ptr += gs * chunk if outc else chunk
    return comms, specs


def _assert_tables_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif f.name in ("stage_in_map", "stage_out_map"):
            assert len(va) == len(vb), f.name
            for x, y in zip(va, vb):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("R", range(2, 9))
def test_build_tables_match_reference_for_every_kind_and_root(R):
    for root in range(R):
        for dtype in ("float32", "bfloat16"):
            kw = dict(n_ranks=R, max_colls=2 * len(KINDS), max_comms=2,
                      slice_elems=4, conn_depth=3 + root % 3,
                      burst_slices=1 + root % 2, dtype=dtype)
            got = []
            for P, C, T in ((jprim, jconfig, jtables),
                            (tprim, tconfig, ttables)):
                cfg = C.OcclConfig(**kw)
                comms, specs = _specs(P, cfg, R, root, rng_seed=R * 10 + root)
                got.append(T.build_tables(cfg, comms, specs))
            _assert_tables_equal(*got)
            assert got[1].chain_src.shape == (2 * len(KINDS), 0)


def test_ring_programs_match_reference():
    from repro.core.algos import build_ring_program as jb
    from repro_torch.core.algos import build_ring_program as tb
    for kind in KINDS:
        for R in range(1, 9):
            for m in range(R):
                for root in range(R):
                    want = [(int(p), c) for p, c in jb(kind, m, R, root)]
                    assert [(int(p), c)
                            for p, c in tb(kind, m, R, root)] == want


def test_config_field_set_and_constants_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.OcclConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.OcclConfig)]
    assert jf == tf
    assert tconfig.QUEUE_KEY_DEMAND_STRIDE == jconfig.QUEUE_KEY_DEMAND_STRIDE
    assert tconfig.QUEUE_KEY_PRIO_STRIDE == jconfig.QUEUE_KEY_PRIO_STRIDE
    cfg = dict(burst_slices=4, conn_depth=4, auto_conn_depth=True)
    assert (tconfig.OcclConfig(**cfg).conn_depth
            == jconfig.OcclConfig(**cfg).conn_depth == 12)


INVALID = [
    dict(n_ranks=0), dict(max_comms=0), dict(conn_depth=0),
    dict(slice_elems=0), dict(burst_slices=0),
    dict(spin_base=1, spin_min=2), dict(algo="bogus"), dict(recorder_len=0),
    dict(prio_aging_quantum=-1), dict(prio_aging_cap=512),
    dict(prio_aging_cap=-1), dict(bandwidth_groups=-1),
    dict(intra_burst_cap=-1), dict(inter_burst_cap=-1),
    dict(n_ranks=8, bandwidth_groups=3),
    dict(superstep_budget=1 << 18),
    dict(superstep_budget=(1 << 18) - 16, max_colls=16),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(kw))
def test_config_rejects_same_inputs_as_reference(kw):
    for C in (jconfig, tconfig):
        with pytest.raises(AssertionError):
            C.OcclConfig(**kw)


def test_config_accepts_boundary_inputs_like_reference():
    for kw in (dict(superstep_budget=(1 << 18) - 19, max_colls=16),
               dict(prio_aging_cap=511), dict(n_ranks=8, bandwidth_groups=4)):
        assert (dataclasses.asdict(tconfig.OcclConfig(**kw))
                == dataclasses.asdict(jconfig.OcclConfig(**kw)))


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_runtime_raises_without_a_card_unless_cpu_requested(monkeypatch):
    from repro_torch.core import OcclConfig, OcclRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = OcclConfig(n_ranks=2, max_colls=2, max_comms=1, slice_elems=4,
                     conn_depth=3, heap_elems=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OcclRuntime(cfg)
    assert OcclRuntime(cfg, device="cpu").device.type == "cpu"


def test_composite_and_unported_paths_raise_not_implemented():
    """Composite registration is ported: two_level lowers to a chain, auto
    resolves, a plan the zoo lacks raises the reference's ValueError.  The
    tick surface is ported (``tick_fn`` and ``device_api`` return their
    objects); so is every model family (the hybrid family here builds its
    shared block)."""
    from repro_torch.configs import get_config
    from repro_torch.core import CollKind, OcclConfig, OcclRuntime
    from repro_torch.models import build_model

    rt = OcclRuntime(OcclConfig(n_ranks=4, max_colls=8, max_comms=3,
                                slice_elems=4, conn_depth=3,
                                heap_elems=1024), device="cpu")
    world = rt.communicator(range(4))
    head = rt.register(CollKind.ALL_REDUCE, world, 16, algo="two_level")
    with pytest.raises(ValueError, match="no registered composite plan"):
        rt.register(CollKind.ALL_GATHER, world, 16, algo="tree")
    auto = rt.register(CollKind.ALL_GATHER, world, 16, algo="auto")
    chains = rt.stats()["chains"]
    assert chains[head] == [head, head + 1, head + 2]
    assert auto not in chains                       # flat ring
    assert callable(rt.tick_fn()) and not rt.device_api().stale
    cfg = get_config("zamba2-1.2b").reduced()
    params = build_model(cfg).init(0, "cpu")
    assert tuple(params["shared"]["proj"].shape) == (2 * cfg.d_model,
                                                     cfg.d_model)
