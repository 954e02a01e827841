"""OCCL-based gradient synchronization (the paper's DNN-training use).

PyTorch port of ``repro.train.occl_sync``.  Gradients are flattened into
size-bounded BUCKETS (paper Sec. 5.3.1).  Each bucket is registered once
as an OCCL all-reduce on the DP communicator; every step the ranks submit
their buckets **in backward order with rising priority** (the
Priority-based Ordering policy of Sec. 3.2), and the daemon gang-schedules
them decentrally.

The leaves are taken in the reference's order (:func:`repro_torch.tree.
tree_leaves`: dict keys sorted) and bucketized in reverse, so bucket
totals, collective ids and every superstep count equal the reference's.
Ranks are the simulated DP workers of the sim backend (all on one
device).  The "static" comparator (statically-sequenced NCCL of the
paper's Sec. 5) is a plain summation in a fixed order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core import CollKind, OcclConfig, OcclRuntime, OrderPolicy
from ..tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class Bucket:
    coll_id: int
    leaf_ids: list[int]
    sizes: list[int]
    total: int


def _numpy_f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().cpu().numpy().ravel()
    return np.asarray(leaf, np.float32).ravel()


class OcclGradSync:
    """compress_wire: bf16 gradient payloads on the connector fabric (half
    the wire bytes; the heap dtype is bf16, results read back widened)."""

    def __init__(self, grads_template, n_ranks: int,
                 bucket_elems: int = 4096, slice_elems: int = 256,
                 priority_preempts: bool = False,
                 compress_wire: bool = False,
                 hierarchy: tuple | None = None,
                 burst_slices: int = 1,
                 bandwidth_groups: int = 0,
                 intra_burst_cap: int = 0,
                 inter_burst_cap: int = 0,
                 device=None):
        """``grads_template``: a tree of tensors (the meta device will do)
        or of anything with ``.shape`` and ``.dtype``.  ``hierarchy=(G,
        N)`` routes every bucket through the composite two-level
        all-reduce instead of the flat ring (G * N == n_ranks).  The burst
        and bandwidth-skew arguments forward the lane model (config.py).
        ``device``: the runtime's (``None``: ``cuda``)."""
        leaves = tree_leaves(grads_template)
        self.template = grads_template
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.n_ranks = n_ranks

        # --- bucketize leaves in reverse (backward) order ----------------
        buckets: list[Bucket] = []
        cur_ids: list[int] = []
        cur_sizes: list[int] = []
        cur_total = 0
        for i in reversed(range(len(leaves))):
            n = int(np.prod(self.shapes[i]))
            if cur_total + n > bucket_elems and cur_ids:
                buckets.append(Bucket(-1, cur_ids, cur_sizes, cur_total))
                cur_ids, cur_sizes, cur_total = [], [], 0
            cur_ids.append(i)
            cur_sizes.append(n)
            cur_total += n
        if cur_ids:
            buckets.append(Bucket(-1, cur_ids, cur_sizes, cur_total))
        self.buckets = buckets

        heap = sum(2 * b.total + 64 * len(buckets) for b in buckets)
        self.compress_wire = compress_wire
        self.hierarchy = hierarchy
        if hierarchy is not None:
            G, N = hierarchy
            assert G * N == n_ranks, (
                f"hierarchy {hierarchy} does not tile {n_ranks} ranks")
        # A two-level bucket is a 3-stage chain: 3 collective slots per
        # bucket, two lanes, and intermediate heap regions (~2x per side).
        n_colls = len(buckets) * (3 if hierarchy is not None else 1)
        self.occl = OcclRuntime(OcclConfig(
            n_ranks=n_ranks,
            max_colls=max(8, n_colls),
            max_comms=2 if hierarchy is not None else 1,
            slice_elems=slice_elems,
            conn_depth=max(8, 3 * burst_slices),
            burst_slices=burst_slices,
            heap_elems=max(1 << 14, 4 * heap)
                       * (2 if hierarchy is not None else 1),
            # In-step submission appends one SQE per bucket per rank into
            # the device SQ — the SQ must hold a whole step's buckets.
            sq_len=max(64, len(buckets) + 4),
            order_policy=OrderPolicy.PRIORITY,
            priority_preempts=priority_preempts,
            superstep_budget=1 << 16,
            dtype="bfloat16" if compress_wire else "float32",
            bandwidth_groups=bandwidth_groups,
            intra_burst_cap=intra_burst_cap,
            inter_burst_cap=inter_burst_cap,
        ), device=device)
        self.device = self.occl.device
        comm = (self.occl.communicator(list(range(n_ranks)))
                if hierarchy is None
                else self.occl.logical_communicator(list(range(n_ranks))))
        for b in buckets:
            b.coll_id = self.occl.register(
                CollKind.ALL_REDUCE, comm, n_elems=b.total,
                algo="ring" if hierarchy is None else "two_level",
                hierarchy=hierarchy)

    # ------------------------------------------------------------------
    def _pack(self, grads, bucket: Bucket) -> np.ndarray:
        """One rank's bucket payload, float32 on the host (rounded to bf16
        first when the wire is compressed, as the reference does)."""
        leaves = tree_leaves(grads)
        out = np.concatenate([_numpy_f32(leaves[i]) for i in bucket.leaf_ids])
        if self.compress_wire:
            out = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
        return out

    def device_api(self):
        """The runtime's in-step submission/tick API (core/device_api.py)
        bound to this sync's bucket registrations."""
        return self.occl.device_api()

    def unflatten(self, flats_by_bucket: Sequence) -> dict:
        """Rebuild one rank's gradient tree from per-bucket flat tensors
        (already averaged), in bucket-index order."""
        leaves = [None] * len(self.shapes)
        for b, flat in zip(self.buckets, flats_by_bucket):
            off = 0
            for i, n in zip(b.leaf_ids, b.sizes):
                leaves[i] = flat[off:off + n].reshape(
                    self.shapes[i]).to(self.dtypes[i])
                off += n
        return tree_unflatten(self.template, leaves)

    def all_reduce(self, per_rank_grads: Sequence) -> list:
        """Average gradients across ranks via OCCL collectives.

        per_rank_grads: one grad tree per DP rank (tensors or numpy
        arrays); returns one averaged tree of tensors per rank, on the
        runtime's device."""
        assert len(per_rank_grads) == self.n_ranks
        for prio, b in enumerate(self.buckets):
            for r in range(self.n_ranks):
                # Payloads are STAGED host-side and flushed to the device
                # in one batched copy by the first launch prologue.
                self.occl.submit(r, b.coll_id, prio=prio,
                                 data=self._pack(per_rank_grads[r], b))
        self.occl.drive()
        reads = self.occl.read_outputs_bulk(
            [(r, b.coll_id) for r in range(self.n_ranks)
             for b in self.buckets])
        outs = []
        for r in range(self.n_ranks):
            flats = []
            for b in self.buckets:
                # read_outputs_bulk returns owned copies: averaged in place.
                flat = np.asarray(reads[(r, b.coll_id)], np.float32)
                flat /= self.n_ranks
                flats.append(torch.from_numpy(flat).to(self.device))
            outs.append(self.unflatten(flats))
        return outs

    def evict(self, rank: int) -> dict:
        """Elastically drop one DP worker: ``OcclRuntime.evict`` (drain ->
        rebuild for R-1 -> replay) and this sync's own rank count.  A
        two-level hierarchy that no longer tiles the shrunk fleet is
        cleared (evict()'s replay falls back to the derived grid)."""
        report = self.occl.evict(rank)
        self.n_ranks = self.occl.cfg.n_ranks
        if self.hierarchy is not None:
            G, N = self.hierarchy
            if G * N != self.n_ranks:
                self.hierarchy = None
        return report

    def stats(self):
        return self.occl.stats()


def static_all_reduce(per_rank_grads: Sequence) -> list:
    """The statically-sequenced baseline: fixed-order averaging."""
    n = len(per_rank_grads)
    avg = tree_map(lambda *xs: sum(x.float() for x in xs) / n,
                   *per_rank_grads)
    return [tree_map(lambda a, t: a.to(t.dtype), avg, per_rank_grads[0])
            for _ in range(n)]
