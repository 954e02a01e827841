"""Multi-pod dry run: prove the distribution config is coherent.

PyTorch port of ``repro.launch.dryrun``.  For every (arch x shape-cell),
PLAN the train / prefill / decode step on a production mesh — 16x16
single-pod and 2x16x16 multi-pod — and record per-device memory, FLOPs and
the collective traffic.  Results land in
``dryrun_results_torch/{arch}__{cell}__{mesh}.json`` at the root of the
repository (never in the reference's ``benchmarks/dryrun_results/``).

Where the reference lowers and compiles with XLA on 512 forced host
devices, the port plans with DTensor on a fake process group
(``launch/mesh.py:make_production_mesh``), on ``meta`` tensors; no card is
needed.  The plan lays out the step's arguments under the sharding rules
(``parallel/sharding.py``: ``state_pspecs`` or ``param_pspecs``, and
``batch_pspecs``) as DTensors whose local shard is rank 0's, then runs the
port's own step body once (``make_train_step``, ``make_prefill_step`` or
``make_decode_step``) under ``implicit_replication()`` (plain tensors the
models build themselves count as replicated) and two recorders:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the DTensor
  ops' GLOBAL shapes (``"flops"``; the reference's ``cost_analysis``
  counts per device), and the same counter over rank 0's local ops
  (``"flops_per_device"``);
* the local ops (:class:`_Recorder`, a dispatch mode below the DTensor
  layer): each ``_c10d_functional`` collective, by the reference's kinds
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``;
  DTensor issues no ``collective-permute``) with its count and
  per-device result bytes, as the reference's ``collective_stats`` reads
  them from HLO; the bytes every other local op reads and writes
  (``"bytes"``, unfused); and the live local bytes.

Per-device memory: ``mem_argument_bytes`` / ``mem_output_bytes`` are the
summed bytes of rank 0's local shards of the step's arguments / outputs
(an output that is an argument updated in place counts as an output too,
as a donated buffer does in the reference); ``mem_temp_bytes`` is the peak,
over the plan, of the live local bytes of every storage the plan created
(freed when its last tensor dies, so ``cfg.remat`` shows), with no
allocator rounding and no fusion.  It is the peak of DTensor's layouts,
which are greedy per op (a train cell's logits, for one, are a Partial
full-vocabulary tensor on every device), not of a tuned plan.

Differences from the reference (ROADMAP.md lists them):

* collectives are the ones DTensor's sharding propagation picks, not
  GSPMD's; a shard-to-shard move counts as one ``all-to-all`` (DTensor
  would fall back to an all-gather plus a chunk on a ``"cpu"`` mesh);
* where DTensor has no sharding rule (the MoE dispatch's
  ``searchsorted``, the router's ``bincount``; ``ops_replicated`` names
  them) the op runs replicated; where a view splits a
  sharded dim across its shard boundaries (heads split into KV heads and
  groups) that one input is replicated first (``views_replicated``), and
  a lookup into a vocab-sharded tensor is reduced at once
  (``lookups_reduced``; :class:`_PlanFixups`); their collectives are
  counted;
* the port runs its layers in a Python loop, so FLOPs and collectives are
  counted at full depth: the reference's three-point unrolled probe
  (``_roofline_probe`` / ``_quad_extrap``) is not ported and
  ``"roofline"`` is filled as the reference's ``full_unroll`` branch
  fills it (``probe_layers: "full"``);
* ``lower_s`` / ``compile_s`` / ``hlo_bytes`` are replaced by ``plan_s``,
  and ``compile_ok`` means the plan completed.

The process group is global to the process, so each cell plans in a fresh
process; ``--all`` runs one subprocess per (arch, cell, mesh), as the
reference does.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --cell train_4k
    python -m repro_torch.launch.dryrun --arch llama3-8b --cell train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every cell, both meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import weakref

import torch

ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = ROOT / "dryrun_results_torch"

# _c10d_functional / _dtensor op -> the reference's collective kind.
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Recorder:
    """A dispatch mode under the DTensor layer: it returns
    ``NotImplemented`` for DTensor ops, so it sees the LOCAL ops DTensor
    runs for rank 0 (and every plain op).  Records collectives, local
    FLOPs, bytes read and written, and the live bytes of the storages the
    plan creates."""

    def __init__(self, argument_storages: set):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        rec = self
        self.collectives: dict[str, dict] = {}
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}     # storage id -> [count, bytes]
        self._args = argument_storages

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                rec.record(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def record(self, func, args, kwargs, out, flop_registry) -> None:
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        if name in COLLECTIVES:
            kind = COLLECTIVES[name]
            r = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            r["count"] += 1
            r["bytes"] += sum(_nbytes(t) for t in outs)
        elif name not in _NO_TRAFFIC:
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += fn(*args, **kwargs, out_val=out)
            ins = _tensors(list(args) + list(kwargs.values()))
            if not all(o._is_view() for o in outs):
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        sid = t.untyped_storage()._cdata
        if sid in self._args:
            return
        ref = self._refs.get(sid)
        if ref is None:
            ref = self._refs[sid] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, sid)

    def _release(self, sid: int) -> None:
        ref = self._refs[sid]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[sid]


@contextlib.contextmanager
def _planning_rules():
    """The planning path's additions to DTensor, for this plan only:

    * a shard-to-shard move is DTensor's own all-to-all op (whose meta
      kernel the plan runs) on any mesh, not the all-gather + chunk that
      DTensor falls back to on a ``"cpu"`` mesh;
    * DTensor's sharding propagation, which runs each new op once on
      global-shape ``meta`` stand-ins to learn its output's shape, runs
      with every dispatch mode off: it is bookkeeping, not the step's
      work, and the recorders would count it."""
    import torch.distributed.tensor.placement_types as pt
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._collective_utils import \
        shard_dim_alltoall
    from torch.utils._python_dispatch import _disable_current_modes

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    prop = DTensor._op_dispatcher.sharding_propagator
    propagate = prop._propagate_tensor_meta_non_cached

    def quiet(*a, **kw):
        with _disable_current_modes():
            return propagate(*a, **kw)

    untouched = pt.shard_dim_alltoall
    assert untouched is shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    prop._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        pt.shard_dim_alltoall = untouched
        del prop._propagate_tensor_meta_non_cached


# What DTensor raises where it has no sharding rule for an op, where its
# rule cannot place these inputs, or where the layout its rule picked
# cannot be reached (torch 2.11: "redistribute from S(0) to P(sum) not
# supported yet"); which of them an op meets depends on the torch version.
_NO_RULE = ("does not have a sharding strategy registered",
            "Sharding propagation failed",
            "not supported yet")


class _PlanFixups:
    """A dispatch mode above the DTensor layer that steers DTensor where it
    has no layout or a bad one, each at the cost of a collective the recorder
    counts:

    * an op with no sharding rule (the MoE dispatch's ``searchsorted``,
      among others), or whose rule cannot place its inputs or picks a
      layout DTensor cannot reach (in some torch versions the embedding's
      backward ``index_put``, a lookup with indices sharded over two mesh
      dims, a shard turned into a partial sum), runs on replicated inputs
      (all-gathers) and gives replicated results; ``aten.bincount`` (the
      router's load count) has no ``meta`` kernel either (its length
      depends on the data), so its result is a replicated ``minlength``
      vector (the expert ids lie below it);
    * a view of a DTensor that splits a sharded dim across its shard
      boundaries (heads split into (KV heads, group) where the dim is
      sharded over more ranks than there are KV heads): DTensor either
      refuses it or returns a strided shard, whose every later
      redistribution it can only plan by a graph search that takes
      minutes per op on the 2x16x16 mesh.  That one input is replicated on
      the mesh dims concerned (an all-gather) and the view taken again;
    * ``argmax`` / ``argmin`` (the decode step's next token) run on a
      replicated input: DTensor's own handler for a sharded reduced dim
      fails on a batch of 1 under the fake process group;
    * a write into a plain tensor the model built itself (the prefill's
      cache buffer, replicated under ``implicit_replication()``) takes a
      replicated copy of each DTensor it writes (an all-gather);
    * ``index_copy_`` (the decode step's cache write): DTensor re-lays the
      cache out under a new spec without moving its data (its strategy's
      output placement need not be the cache's).  The write runs on the
      cache's own shards, the new entries laid out as the cache is
      (replicated along the written dim);
    * the masked partial sum of a lookup into a vocab-sharded tensor (the
      embedding, the cross-entropy's gather of the target logits): DTensor
      carries its mask into later ops, where reducing it fails
      (``_mask_buffer.apply_mask``: ``IndexError``).  The lookup's result
      is reduced at once (an all-reduce), as a vocab-parallel embedding
      does."""

    VIEWS = ("view", "_unsafe_view")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        owner = self
        self.views = self.lookups = 0
        self.unsharded: set[str] = set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                x = args[0] if args else None
                if not isinstance(x, DTensor):
                    if isinstance(x, torch.Tensor) and \
                            func._schema.is_mutable and any(
                                isinstance(a, DTensor) for a in _tensors(
                                    list(args) + list(kwargs.values()))):
                        return owner.replicated(func, args, kwargs,
                                                wrap_out=False)
                    return func(*args, **kwargs)
                if func._overloadpacket in (torch.ops.aten.argmax,
                                            torch.ops.aten.argmin):
                    return owner.replicated(func, args, kwargs)
                if func._overloadpacket.__name__ in _PlanFixups.VIEWS:
                    return owner.view(func, args, kwargs)
                if func is torch.ops.aten.bincount.default:
                    return owner.bincount(*args, **kwargs)
                if func is torch.ops.aten.index_copy_.default:
                    return owner.index_copy_(*args, **kwargs)
                try:
                    out = func(*args, **kwargs)
                except (NotImplementedError, RuntimeError) as e:
                    if not any(m in str(e) for m in _NO_RULE):
                        raise
                    return owner.replicated(func, args, kwargs)
                return owner.reduce_masked(out)

        self.mode = Mode()

    def view(self, func, args, kwargs):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.placement_types import _StridedShard

        x = args[0]
        try:
            out = func(*args, **kwargs)
        except RuntimeError:          # DTensor refused the view
            bad = [i for i, p in enumerate(x.placements)
                   if not p.is_replicate()]
        else:
            bad = [i for i, p in enumerate(out.placements)
                   if isinstance(p, _StridedShard)]
            if not bad:
                return out
        self.views += 1
        whole = x.redistribute(x.device_mesh, [
            Replicate() if i in bad else p
            for i, p in enumerate(x.placements)])
        return func(whole, *args[1:], **kwargs)

    def replicated(self, func, args, kwargs, wrap_out: bool = True):
        """``func`` on every DTensor argument replicated, its tensor
        results replicated DTensors (``wrap_out``) or as they are."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = next(a for a in _tensors(list(args) + list(kwargs.values()))
                    if isinstance(a, DTensor)).device_mesh
        whole = [Replicate()] * mesh.ndim
        self.unsharded.add(func._overloadpacket.__name__)

        def local(a):
            if isinstance(a, DTensor):
                return a.redistribute(mesh, whole).to_local()
            if isinstance(a, (list, tuple)):
                return type(a)(local(x) for x in a)
            return a

        def wrap(o):
            if isinstance(o, torch.Tensor):
                return DTensor.from_local(o, mesh, whole, run_check=False)
            if isinstance(o, (list, tuple)):
                return type(o)(wrap(x) for x in o)
            return o

        out = func(*local(args), **{k: local(v) for k, v in kwargs.items()})
        if isinstance(args[0], DTensor) and func._schema.is_mutable:
            return args[0]          # in place: the values are meta anyway
        return wrap(out) if wrap_out else out

    def index_copy_(self, x, dim, index, src):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = x.device_mesh
        dim = dim % x.ndim
        rows = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                for p in x.placements]
        local = lambda t, places: t.redistribute(mesh, places).to_local() \
            if isinstance(t, DTensor) else t
        x.to_local().index_copy_(dim, local(index, [Replicate()] * mesh.ndim),
                                 local(src, rows))
        return x

    def bincount(self, x, weights=None, minlength=0):
        from torch.distributed.tensor import DTensor, Replicate

        whole = [Replicate()] * x.device_mesh.ndim
        x.redistribute(x.device_mesh, whole)
        local = torch.empty((minlength,), dtype=torch.int64, device="meta")
        return DTensor.from_local(local, x.device_mesh, whole,
                                  run_check=False)

    def reduce_masked(self, out):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor._ops._embedding_ops import _MaskPartial

        if not isinstance(out, DTensor) or not any(
                isinstance(p, _MaskPartial) for p in out.placements):
            return out
        self.lookups += 1
        return out.redistribute(out.device_mesh, [
            Replicate() if isinstance(p, _MaskPartial) else p
            for p in out.placements])


def n_params(tree) -> int:
    from ..tree import tree_leaves

    return int(sum(math.prod(l.shape) for l in tree_leaves(tree)))


def active_params(cfg, params) -> tuple[int, int]:
    """(N_matmul_total, N_matmul_active): matrix params (ndim>=2, no embed),
    with routed-expert stacks scaled by top_k/E for the active count."""
    from ..tree import tree_leaves_with_path

    total = active = 0
    for path, leaf in tree_leaves_with_path(params):
        names = path.split("/")
        if leaf.ndim < 2 or names[-1] == "embed":
            continue
        n = int(math.prod(leaf.shape))
        total += n
        if cfg.n_experts and "moe" in names and names[-1] in ("wg", "wu", "wd"):
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    return total, active


def _step_arguments(cfg, cell, mesh):
    """(step, arguments, model_tokens, flops_per_param) of the cell on
    ``mesh``: one ``(values, shardings)`` pair of trees per argument of
    the step, the values ``meta`` tensors or ``TensorSpec``s."""
    from ..models import build_model, input_specs
    from ..parallel.sharding import (NamedSharding, P, batch_pspecs,
                                     data_axes, param_shardings)
    from ..train.state import abstract_state, state_shardings
    from ..train.step import (make_decode_step, make_prefill_step,
                              make_train_step)
    from ..tree import tree_map

    specs = input_specs(cfg, cell)
    bspecs = batch_pspecs(mesh, specs)
    to_sh = lambda tree: tree_map(lambda s: NamedSharding(mesh, s), tree)

    if cell.kind == "train":
        st = abstract_state(cfg)
        return (make_train_step(cfg),
                [(st, state_shardings(mesh, cfg, st)),
                 (specs, to_sh(bspecs))],
                cell.global_batch * cell.seq_len, 6)
    params = build_model(cfg).init(0, "meta")
    p = (params, param_shardings(mesh, params))
    if cell.kind == "prefill":
        return (make_prefill_step(cfg), [p, (specs, to_sh(bspecs))],
                cell.global_batch * cell.seq_len, 2)
    tok_spec = P(data_axes(mesh)) if cell.global_batch > 1 else P(None)
    return (make_decode_step(cfg),
            [p, (specs["cache"], to_sh(bspecs["cache"])),
             (specs["tokens"], NamedSharding(mesh, tok_spec))],
            cell.global_batch, 2)


def spec_argument_bytes(cfg, cell, mesh) -> int:
    """Per-device argument bytes of the cell's step reckoned from the
    specs alone: each leaf's largest shard (rank 0's).  ``mesh`` may be a
    placement mesh; only its axis sizes are read."""
    from ..parallel.sharding import shard_bytes
    from ..tree import tree_leaves

    _, arguments, _, _ = _step_arguments(cfg, cell, mesh)
    return sum(shard_bytes(t.shape, t.dtype, sh)
               for values, shardings in arguments
               for t, sh in zip(tree_leaves(values), tree_leaves(shardings)))


def state_plan_bytes(cfg, mesh) -> int:
    """Rank 0's local bytes of the train state (``abstract_state``) laid
    out on a planning mesh under ``state_shardings``."""
    from ..train.state import abstract_state, state_shardings
    from ..tree import tree_leaves

    st = abstract_state(cfg)
    return sum(_nbytes(_local(t)) for t in tree_leaves(
        _lay_out(st, state_shardings(mesh, cfg, st))))


def _lay_out(tree, shardings):
    """DTensors on ``meta`` for a tree of tensors or ``TensorSpec``s under
    a tree of ``NamedSharding``s on a planning mesh: each holds rank 0's
    local shard."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import placements
    from ..tree import tree_map

    def one(t, sh):
        shape = torch.Size(t.shape)
        local = torch.empty(sh.shard_shape(shape), dtype=t.dtype,
                            device="meta")
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(
            local, sh.mesh, placements(sh.spec, sh.mesh, len(shape)),
            run_check=False, shape=shape, stride=stride)

    return tree_map(one, tree, shardings)


def plan_cell(cfg, cell, mesh) -> dict:
    """Plan ``cell``'s step of ``cfg`` on a planning mesh: the result's
    memory, FLOPs and collectives (see the module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from ..tree import tree_leaves

    t0 = time.perf_counter()
    step, arguments, model_tokens, flops_per_param = _step_arguments(
        cfg, cell, mesh)
    args = [_lay_out(*a) for a in arguments]
    arg_locals = [_local(t) for t in _tensors(tree_leaves(args))]
    rec = _Recorder({t.untyped_storage()._cdata for t in arg_locals})
    fixups = _PlanFixups()
    flop_counter = FlopCounterMode(display=False)
    with _planning_rules(), implicit_replication(), rec.mode, \
            flop_counter, fixups.mode:
        out = step(*args)
    outs = [_local(t) for t in _tensors(tree_leaves(out))]
    colls = {k: rec.collectives[k] for k in sorted(rec.collectives)}
    cost = {
        "flops": float(flop_counter.get_total_flops()),
        "flops_per_device": float(rec.flops),
        "bytes": float(rec.bytes),
        "collectives": colls,
        "coll_bytes": float(sum(c["bytes"] for c in colls.values())),
    }
    return {
        "cost": cost,
        "mem_argument_bytes": sum(_nbytes(t) for t in arg_locals),
        "mem_output_bytes": sum(_nbytes(t) for t in outs),
        "mem_temp_bytes": rec.peak,
        "views_replicated": fixups.views,
        "lookups_reduced": fixups.lookups,
        "ops_replicated": sorted(fixups.unsharded),
        "model_tokens": model_tokens,
        "flops_per_param": flops_per_param,
        "plan_s": time.perf_counter() - t0,
    }


def run_cell(arch: str, cell_name: str, multi_pod: bool,
             out_path: pathlib.Path | None = None) -> dict:
    from ..configs import get_config
    from ..configs.base import SHAPES
    from ..models import build_model
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    cell = SHAPES[cell_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"

    plan = plan_cell(cfg, cell, mesh)
    n_total, n_active = active_params(cfg, build_model(cfg).init(0, "meta"))
    model_flops = plan["flops_per_param"] * n_active * plan["model_tokens"]
    cost = plan["cost"]
    result = {
        "arch": arch, "cell": cell_name, "mesh": mesh_name,
        "n_devices": 512 if multi_pod else 256,
        "kind": cell.kind,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "compile_ok": True,
        "full_unroll": True,
        "rolled": cost,
        "mem_argument_bytes": plan["mem_argument_bytes"],
        "mem_output_bytes": plan["mem_output_bytes"],
        "mem_temp_bytes": plan["mem_temp_bytes"],
        "n_params_matmul": n_total,
        "n_params_active": n_active,
        "model_flops_global": float(model_flops),
        "model_tokens": plan["model_tokens"],
        "views_replicated": plan["views_replicated"],
        "lookups_reduced": plan["lookups_reduced"],
        "ops_replicated": plan["ops_replicated"],
        "plan_s": round(plan["plan_s"], 2),
        "roofline": dict(cost, probe_layers="full"),
    }
    print(json.dumps(result, indent=1))
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    return result


def _cell_path(arch, cell, multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    return RESULTS_DIR / f"{arch}__{cell}__{mesh}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        from ..configs import all_cells
        todo = [(a, c, mp) for a, c in all_cells() for mp in (False, True)]
        env = dict(os.environ)
        src = str(pathlib.Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        failed = []
        for arch, cell, mp in todo:
            path = _cell_path(arch, cell, mp)
            if path.exists() and not args.force:
                print(f"skip (cached): {path.name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--cell", cell]
            if mp:
                cmd.append("--multi-pod")
            print(f"=== {arch} {cell} {'2x16x16' if mp else '16x16'} ===",
                  flush=True)
            r = subprocess.run(cmd, cwd=str(ROOT), env=env)
            if r.returncode != 0:
                failed.append((arch, cell, mp))
        if failed:
            print("FAILED cells:", failed)
            sys.exit(1)
        print("ALL CELLS PASSED")
        return

    out = _cell_path(args.arch, args.cell, args.multi_pod)
    run_cell(args.arch, args.cell, args.multi_pod, out)


if __name__ == "__main__":
    main()
