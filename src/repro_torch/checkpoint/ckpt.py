"""Checkpointing: save/restore with a manifest, an async writer and an
atomic commit.

PyTorch port of ``repro.checkpoint.ckpt``, on the reference's on-disk
layout, so a checkpoint written by either package restores in the other:

    <dir>/step_<N>/
        manifest.json        {key -> {file, shape, dtype, crc32}}
        <key with / as __>.npy   one file per leaf
        extras.json          data-pipeline cursor and other metadata

Keys are the reference's (``repro_torch.tree.tree_leaves_with_path``: a
``TrainState`` gives ``.params/embed``, ``.m/...``, ``.step``).
Everything is written into ``step_<N>.tmp`` and renamed; ``keep`` committed
steps are retained.  ``restore`` checks each leaf's CRC and shape, then
places each leaf that ``shardings=`` names onto its placement mesh
(:func:`repro_torch.parallel.sharding.device_put`: elastic resharding, the
checkpoint has no memory of the mesh it was saved from) and puts the rest
on ``device``.  ``save`` takes a sharded leaf
(:class:`~repro_torch.parallel.sharding.ShardedTensor`) and writes the
gathered array, so the files do not depend on the mesh either.

bfloat16 leaves are stored as the JAX package stores them: ``np.save`` of an
``ml_dtypes`` bfloat16 array writes raw two-byte records under
``descr '<V2'``, with manifest dtype ``"bfloat16"`` and the CRC of those
bytes.  The port writes the same file from the tensor's ``int16`` view and
reads one back through that view, so it needs no ``ml_dtypes``.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..parallel.sharding import ShardedTensor, device_put
from ..tree import tree_leaves_with_path, tree_map, tree_unflatten

BF16_DESCR = "<V2"      # what np.save writes for an ml_dtypes bfloat16 array


def _host(leaf) -> Any:
    """A leaf's own host copy: a CPU tensor that no later in-place update
    of ``leaf`` can reach (a sharded leaf gathered), or the leaf itself
    when it is not a tensor."""
    if isinstance(leaf, ShardedTensor):
        return leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


def _as_numpy(leaf) -> tuple[np.ndarray, str]:
    """(contiguous array of the leaf's bytes, manifest dtype name)."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(arr) & 0xFFFFFFFF


def _write(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        arr.tofile(f)


def _read(path: pathlib.Path, dtype: str) -> np.ndarray:
    arr = np.load(path)
    return arr.view(np.int16) if dtype == "bfloat16" else arr


def save(directory, step: int, tree, extras: Optional[dict] = None,
         keep: int = 3) -> pathlib.Path:
    directory = pathlib.Path(directory)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {}
    for key, leaf in tree_leaves_with_path(tree):
        arr, dtype = _as_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        _write(tmp / fn, arr, dtype)
        manifest[key] = {"file": fn, "shape": list(arr.shape),
                         "dtype": dtype, "crc32": _crc32(arr)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    (tmp / "extras.json").write_text(json.dumps(extras or {}, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                    # atomic commit

    # retention
    steps = sorted((int(p.name.split("_")[1]) for p in directory.glob("step_*")
                    if not p.name.endswith(".tmp")))
    for old in steps[:-keep]:
        shutil.rmtree(directory / f"step_{old}", ignore_errors=True)
    return final


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory, step: int, template, *, shardings=None,
            device=None, validate: bool = True):
    """Rebuild a ``template``-shaped tree from disk; each leaf takes its
    template leaf's dtype.  A leaf that ``shardings`` (a tree of
    :class:`~repro_torch.parallel.sharding.NamedSharding` on placement
    meshes, keyed like ``template``) names is split over its mesh; the
    others go to ``device`` (``None``: the template leaf's device).
    Returns ``(tree, extras)``."""
    d = pathlib.Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_shards = dict(tree_leaves_with_path(shardings)) \
        if shardings is not None else {}

    loaded = {}
    for key, meta in manifest.items():
        arr = _read(d / meta["file"], meta["dtype"])
        if validate and _crc32(arr) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {key}")
        t = torch.from_numpy(arr)
        loaded[key] = t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" \
            else t

    ordered = []
    for key, leaf in tree_leaves_with_path(template):
        if key not in loaded:
            raise KeyError(f"checkpoint missing {key}")
        got = loaded[key]
        if tuple(got.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{key}: ckpt shape {tuple(got.shape)} != template "
                f"{tuple(leaf.shape)}")
        if key in flat_shards:
            ordered.append(device_put(got.to(leaf.dtype), flat_shards[key]))
        else:
            ordered.append(got.to(device=leaf.device if device is None
                                  else device, dtype=leaf.dtype))
    tree = tree_unflatten(template, ordered)
    extras = json.loads((d / "extras.json").read_text())
    return tree, extras


class AsyncCheckpointer:
    """Background-thread writer: training never blocks on disk.  The tree
    is copied to the host before the thread starts, so a step that updates
    the state in place cannot race the writer."""

    def __init__(self, directory, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.error: Optional[BaseException] = None

    def save_async(self, step: int, tree, extras: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(_host, tree)

        def work():
            try:
                save(self.directory, step, host_tree, extras, self.keep)
                self.last_saved = step
            except BaseException as e:  # surfaced on next wait()
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
