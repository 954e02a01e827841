"""Production and host meshes.

PyTorch port of ``repro.launch.mesh``.  Defined as FUNCTIONS so importing
this module touches no device and no process group; only a call does.

* :func:`make_production_mesh` is the PLANNING mesh of the dry run
  (``launch/dryrun.py``): a DTensor ``DeviceMesh`` of 16x16 ranks
  (``("data", "model")``) or 2x16x16 (``("pod", "data", "model")``) over a
  fake process group of 256 or 512 ranks in this one process, on which the
  dry run lays out ``meta`` tensors.  It is the counterpart of the
  reference's compile-only run on 512 forced host devices and needs no
  card.  The process group is global to the process, so a process plans on
  one production mesh only.
* :func:`make_host_mesh` is a PLACEMENT mesh
  (:class:`repro_torch.parallel.sharding.Mesh`) over real devices, for
  :func:`~repro_torch.parallel.sharding.device_put` and an elastic
  checkpoint restore.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _fake_process_group(world_size: int) -> None:
    """Rank 0 of a ``world_size``-rank fake process group: collectives
    return at once and move nothing, which is all a plan on ``meta``
    needs.  A group of another size already open raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a {dist.get_world_size()}-rank process group is open; "
                f"this process cannot plan on {world_size} ranks")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_planning_mesh(shape: tuple, axes: tuple):
    """A planning mesh of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    _fake_process_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ranks per pod ("data", "model"); 2 pods adds the "pod" axis."""
    if multi_pod:
        return make_planning_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_planning_mesh((16, 16), ("data", "model"))


def make_host_mesh(model: int | None = None, devices=None):
    """A placement mesh ("data", "model") over ``devices`` (default: every
    CUDA device, raising when there is none): ``model`` defaults to 2 on an
    even count above 1, else 1, and ``data`` takes the rest, as in the
    reference."""
    from ..parallel.sharding import Mesh

    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_host_mesh: no CUDA device; pass "
                               "devices= to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    n = len(devices)
    model = model or (2 if n % 2 == 0 and n > 1 else 1)
    data = n // model
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model), ("data", "model"))
