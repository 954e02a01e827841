"""Sharding rules: parameter and activation partition specs, and the two
kinds of mesh they are read on.

PyTorch port of ``repro.parallel.sharding``.  Axes of the production mesh
(``launch/mesh.py``):
    pod   — multi-pod data parallelism (2-way in the 512-rank dry run)
    data  — in-pod data parallelism (16-way); also the ZeRO-1 shard axis
    model — tensor/expert parallelism (16-way)

Parameter rules are name+shape based (Megatron-style):
    column-parallel (out-dim on "model"): wq wk wv wg wu w1 z_proj x_proj
        dt_proj shared_wg shared_wu lm_head head vis_proj patch_proj
    row-parallel (in-dim on "model"):     wo wd w2 out_proj shared_wd
    vocab-parallel:                       embed (dim 0)
    expert-parallel (dim E on "model"):   moe wg/wu/wd
    head-parallel small vectors:          A_log D_skip dt_bias gate_norm
                                          conv_x_* (SSM d_inner shards)
    replicated:                           norms, biases, router, B/C proj

A spec (:class:`PartitionSpec`, ``P``) is the reference's, read as data:
one entry per leading dim, each ``None``, an axis name or a tuple of axis
names (major to minor).  Trees are the port's nested dicts
(:mod:`repro_torch.tree`); a leaf's own key plays the reference's
``names[-1]``.  A spec is read on one of two meshes:

* a **placement mesh** (:class:`Mesh`): a named ``numpy`` object array of
  ``torch.device`` entries, one controller in one process (the shape of
  the mesh backend, ``OcclRuntime(cfg, mesh=...)``).  :func:`device_put`
  splits a tensor into one shard per mesh position (ceil-sized chunks, the
  last one short, as ``jax.device_put`` does) and returns a
  :class:`ShardedTensor`.  A device set counts positions, not distinct
  devices: 2x2 x ``cuda`` holds four.
* a **planning mesh**: a DTensor ``DeviceMesh`` over a fake process group
  (``launch/mesh.py:make_production_mesh``).  :func:`placements` turns a
  spec into DTensor placements (the mesh dim a tensor dim names is
  ``Shard(dim)``, the others ``Replicate()``), and :func:`constrain` is the
  reference's ``with_sharding_constraint`` for the models' hooks.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import numpy as np
import torch

from ..core.state import resolve_device
from ..tree import tree_leaves_with_path, tree_map, tree_unflatten

# name -> (rule) where rule picks the sharded dim
_COL = {"wq", "wk", "wv", "wg", "wu", "w1", "z_proj", "x_proj", "dt_proj",
        "shared_wg", "shared_wu", "lm_head", "head", "vis_proj",
        "patch_proj"}
_ROW = {"wo", "wd", "w2", "out_proj", "shared_wd"}
_VEC_MODEL = {"A_log", "D_skip", "dt_bias", "gate_norm", "conv_x_w",
              "conv_x_b"}


class PartitionSpec:
    """The reference's ``jax.sharding.PartitionSpec``: one entry per
    leading dim (``None``, an axis name, or a tuple of axis names major to
    minor; a one-name tuple reads as the name, as in JAX); dims past the
    last entry are unsharded.  Not a tuple, so the port's tree functions
    take it as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes that shard ``dim``, major to minor."""
        e = self._entries[dim] if dim < len(self._entries) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)


P = PartitionSpec


class Mesh:
    """A placement mesh: ``devices`` (a numpy object array of
    ``torch.device``, one per position; entries may repeat) with one name
    per axis.  Each entry is resolved as the port's entry points resolve a
    device: a ``cuda`` entry raises when no card is present."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices, axes {axis_names}")
        flat = [resolve_device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self):
        """Every mesh position (an index tuple), in row-major order."""
        return itertools.product(*(range(n) for n in self.devices.shape))

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, {devices})"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a placement mesh or a DTensor
    ``DeviceMesh``."""
    if isinstance(mesh, Mesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of a placement mesh, a DTensor ``DeviceMesh`` or any
    object with ``axis_names`` (all that :func:`batch_pspecs` reads)."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` read on ``mesh`` (a placement or a planning mesh)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def device_set(self) -> set:
        """The mesh positions that hold a shard: all of them."""
        return set(self.mesh.positions())

    def shard_counts(self, ndim: int) -> tuple[int, ...]:
        """Shards along each dim: the product of its axes' sizes."""
        sizes = axis_sizes(self.mesh)
        return tuple(math.prod(sizes[a] for a in self.spec.axes(d))
                     for d in range(ndim))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The largest shard's shape (every dim rounded up)."""
        return tuple(-(-int(n) // k) for n, k in
                     zip(shape, self.shard_counts(len(shape))))

    def index(self, pos: tuple, shape) -> tuple[slice, ...]:
        """The slices of a ``shape``-d array that position ``pos`` of a
        placement mesh holds: along each dim, chunk number
        ``sum(pos[a] * (sizes of the axes after a))`` over the dim's axes
        (major to minor), chunks of ``ceil(n / shards)``, the last short or
        empty."""
        sizes = axis_sizes(self.mesh)
        at = dict(zip(self.mesh.axis_names, pos))
        out = []
        for d, (n, c) in enumerate(zip(shape, self.shard_shape(shape))):
            k = 0
            for a in self.spec.axes(d):
                k = k * sizes[a] + at[a]
            out.append(slice(min(k * c, n), min((k + 1) * c, n)))
        return tuple(out)


def shard_bytes(shape, dtype, sharding: NamedSharding) -> int:
    """Bytes of the largest shard (rank 0's) of a ``shape``/``dtype`` leaf
    under ``sharding``: the per-device argument bytes of the reference's
    compile."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return math.prod(sharding.shard_shape(shape)) * itemsize


# ----------------------------------------------------------------------
# the placement mesh's sharded leaves
# ----------------------------------------------------------------------
class ShardedTensor:
    """A tensor split over a placement mesh: ``shards[pos]`` is position
    ``pos``'s own tensor on ``mesh.devices[pos]`` (a replicated dim gives
    each position its own copy)."""

    def __init__(self, shards: dict, sharding: NamedSharding, shape,
                 dtype: torch.dtype):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self) -> list:
        """``(position, index, tensor)`` per position, row-major."""
        return [(pos, self.sharding.index(pos, self.shape), self.shards[pos])
                for pos in self.sharding.mesh.positions()]

    def nbytes_by_position(self) -> dict:
        return {pos: t.numel() * t.element_size()
                for pos, t in self.shards.items()}

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first position's),
        each block read from the first position that holds it."""
        first = next(iter(self.sharding.mesh.positions()))
        dev = self.shards[first].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for pos, idx, t in self.addressable_shards:
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                out[idx] = t.to(dev)
                done.add(key)
        return out


def device_put(x, sharding: NamedSharding) -> ShardedTensor:
    """Split ``x`` (a tensor or numpy array) over ``sharding``'s placement
    mesh: each position gets its own copy of its chunk on its device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    mesh = sharding.mesh
    shards = {pos: t[sharding.index(pos, t.shape)].to(
        mesh.devices[pos], copy=True).contiguous()
        for pos in mesh.positions()}
    return ShardedTensor(shards, sharding, t.shape, t.dtype)


# ----------------------------------------------------------------------
# the planning mesh: DTensor placements
# ----------------------------------------------------------------------
def placements(spec: PartitionSpec, mesh, ndim: int) -> tuple:
    """DTensor placements of ``spec`` on a planning mesh: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.
    A dim sharded over several axes must name them in mesh order (major to
    minor), which is DTensor's chunk order (tests/test_torch_sharding.py
    holds it to the reference's)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d in range(ndim):
        axes = spec.axes(d)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(f"{spec}: axes of dim {d} out of mesh "
                                      f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x, spec: PartitionSpec):
    """The reference's ``with_sharding_constraint`` as the models' hooks
    use it: a DTensor is redistributed to ``spec`` on its own mesh; any
    other tensor is returned as it is (no mesh, no constraint)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(spec, x.device_mesh, x.ndim))


# ----------------------------------------------------------------------
# parameter specs
# ----------------------------------------------------------------------
def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _spec_for(path: str, leaf) -> PartitionSpec:
    names = path.split("/")
    name = names[-1]
    in_moe = "moe" in names
    nd = leaf.ndim

    if name == "embed":
        return P(*(["model"] + [None] * (nd - 1)))
    if in_moe and name in ("wg", "wu", "wd"):
        # [L, E, D, F] or [E, D, F]: shard E (dim -3) over model
        spec = [None] * nd
        spec[nd - 3] = "model"
        return P(*spec)
    if name in _COL or name in _VEC_MODEL:
        spec = [None] * nd
        spec[nd - 1] = "model"
        return P(*spec)
    if name in _ROW:
        spec = [None] * nd
        spec[nd - 2] = "model"
        return P(*spec)
    return P()  # replicated (norms, biases, router, B/C projections)


def param_pspecs(params) -> Any:
    """PartitionSpec tree matching a parameter tree."""
    return tree_unflatten(params, [_spec_for(k, leaf) for k, leaf in
                                   tree_leaves_with_path(params)])


def param_shardings(mesh, params) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), param_pspecs(params))


# ----------------------------------------------------------------------
# activation / batch specs
# ----------------------------------------------------------------------
def batch_pspecs(mesh, specs: dict) -> dict:
    """PartitionSpecs for an ``input_specs()`` dict (train/prefill/decode).
    Reads only the mesh's axis names."""
    da = data_axes(mesh)
    out = {}
    for key, val in specs.items():
        if key == "cache":
            out[key] = {k: _cache_spec(mesh, k, v) for k, v in val.items()}
        else:
            out[key] = _batch_spec(da, key, val)
    return out


def _batch_spec(da, key, v):
    if v.ndim == 0 or v.shape[0] == 1:
        # batch=1 cells (long_500k): parallelism lives in the sequence /
        # state dims; the batch dim is replicated.
        return P(*([None] * v.ndim))
    return P(da, *([None] * (v.ndim - 1)))


def _cache_spec(mesh, key, v):
    """Decode-cache shardings.  Batch over data axes; the long sequence
    dimension of KV caches over "model" (sequence-parallel cache); SSM
    states over heads ("model").  batch=1 long-context cells shard the
    sequence over data+model instead."""
    da = data_axes(mesh)
    if v.ndim == 0:
        return P()
    if key in ("k", "v", "shared_k", "shared_v"):
        # [L, B, S, kv, dh]
        B = v.shape[1]
        if B == 1:
            return P(None, None, da + ("model",), None, None)
        return P(None, da, "model", None, None)
    if key == "state":        # [L, B, H, N, P]
        B = v.shape[1]
        return P(None, None if B == 1 else da, "model", None, None)
    if key in ("conv_x",):    # [L, B, K-1, d_inner]
        B = v.shape[1]
        return P(None, None if B == 1 else da, None, "model")
    if key in ("conv_B", "conv_C"):
        B = v.shape[1]
        return P(None, None if B == 1 else da, None, None)
    if key == "enc_out":      # [B, Sf, D]
        return P(da, None, None)
    return P()


def logical_out_shardings(mesh, tree_spec) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), tree_spec)
