"""Staging engine: logical payloads <-> the padded heap layout.

PyTorch port of ``repro.core.staging.StagingEngine``.  The padded chunk
layout of every collective is resolved once at registration
(:class:`~repro_torch.core.tables.StaticTables` ``stage_in_map`` /
``stage_out_map``); per write or read set the engine builds a plan — the
host-side pack indices and the heap segments the set touches, with adjacent
regions coalesced — cached by the (rank, collective, base-offset) signature.

* **write**: the logical payloads are packed host-side into the padded
  layout (pad positions zero-filled, so stale heap data can never leak into
  the padded slices), shipped in ONE host-to-device copy, and written into
  ``heap_in`` IN PLACE by slice copies — one per coalesced segment, or one
  2D copy when the set is a dense block of consecutive ranks.  The
  reference gets the same in-place effect from buffer donation.  Writes in
  one batch touching overlapping regions apply in (rank, offset)-sorted
  order, last write winning.
* **read**: the coalesced ``heap_out`` segments are concatenated on the
  device, moved in ONE device-to-host copy and un-padded with the maps.
  Results are owned arrays.  A 16-bit float heap is read back widened to
  float32 for bfloat16 (numpy has no bfloat16 type) and as float16 for
  float16; the widening is exact.

On the mesh backend (a :class:`~repro_torch.core.state.ShardedState`, rank
r's heaps on its own device) every copy is per rank: a write ships each
rank's rows host-to-device onto that rank's device only, and a read moves
each rank's segments device-to-host from its own.  A write set that is one
dense block covering every rank with one column window (the grad-sync /
all-ranks-submit shape) is the reference's sharded flush: one row copy per
rank, counted in ``sharded_flushes``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import OcclConfig
from .state import DaemonState, ShardedState
from .tables import StaticTables

# Host dtype a payload is packed in before its one host-to-device copy (the
# device then rounds to the heap dtype, round-to-nearest-even).
_HOST_DTYPES = {"float32": np.float32, "bfloat16": np.float32,
                "float16": np.float16}


def _merge_segments(segs):
    """Coalesce (rank, off, span) runs that are adjacent in the heap.
    ``segs`` must be (rank, off)-sorted; returns the merged list."""
    merged = []
    for rank, off, span in segs:
        if merged and merged[-1][0] == rank \
                and merged[-1][1] + merged[-1][2] == off:
            r, o, s = merged[-1]
            merged[-1] = (r, o, s + span)
        else:
            merged.append((rank, off, span))
    return merged


def _stacked(merged) -> Optional[tuple]:
    """(r0, off, span) if the merged segments form one dense rank-range
    block — identical column window on consecutive ranks — which executes
    as a single 2D copy; None otherwise."""
    if not merged:
        return None
    offs = {(o, s) for _, o, s in merged}
    ranks = [r for r, _, _ in merged]
    if len(offs) == 1 and ranks == list(range(ranks[0],
                                               ranks[0] + len(ranks))):
        _, off, span = merged[0]
        return ranks[0], off, span
    return None


@dataclasses.dataclass
class _WritePlan:
    stack: Optional[tuple]     # dense block of the merged segments, or None
    merged: list
    src: np.ndarray            # packed position -> logical position
    mask: np.ndarray           # packed position holds logical data
    identity: bool             # pad-free: packed order IS logical order


@dataclasses.dataclass
class _ReadPlan:
    merged: list
    # (rank, coll_id, base) -> (packed position, logical size, unpad map or
    # None for the pad-free identity layout)
    slot_by_key: dict


def _copy_segments(heap: torch.Tensor, packed: torch.Tensor, stack,
                   merged) -> None:
    if stack is not None:
        r0, off, span = stack
        heap[r0:r0 + len(merged), off:off + span].copy_(
            packed.view(len(merged), span))
        return
    o = 0
    for rank, off, span in merged:
        heap[rank, off:off + span].copy_(packed[o:o + span])
        o += span


def _to_host(parts: list) -> np.ndarray:
    """Device segments -> one numpy array, in one device-to-host copy
    (bfloat16 widened to float32, exactly)."""
    t = parts[0] if len(parts) == 1 else torch.cat(parts)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class StagingEngine:
    """Pack/unpack between logical user payloads and the padded heap
    layout, via precomputed index maps and per-signature plans."""

    def __init__(self, cfg: OcclConfig, tables: StaticTables):
        self.cfg = cfg
        self.t = tables
        self._host_dtype = np.dtype(_HOST_DTYPES[cfg.dtype])
        self._write_plans: dict = {}
        self._read_plans: dict = {}
        # Flush observability: writes and payload bytes shipped, and how
        # many writes took the mesh's sharded placement.
        self.flush_writes = 0
        self.flush_bytes = 0
        self.sharded_flushes = 0

    # -- writes ----------------------------------------------------------
    def _write_plan(self, sig) -> _WritePlan:
        """``sig`` is the (rank, base)-SORTED (rank, coll_id, base) tuple,
        so every caller-order permutation of one write set hits one plan."""
        plan = self._write_plans.pop(sig, None)
        if plan is not None:
            self._write_plans[sig] = plan    # touch: LRU re-insert
            return plan
        t = self.t
        segs, src, mask = [], [], []
        logical = 0
        for rank, cid, base in sig:
            span = int(t.in_span[cid])
            m = t.stage_in_map[cid]
            s = np.zeros(span, np.int64)
            s[m] = logical + np.arange(m.size, dtype=np.int64)
            ok = np.zeros(span, bool)
            ok[m] = True
            src.append(s)
            mask.append(ok)
            segs.append((int(rank), int(base), span))
            logical += m.size
        src = np.concatenate(src)
        mask = np.concatenate(mask)
        identity = bool(mask.all()) and bool(
            (src == np.arange(src.size)).all())
        merged = _merge_segments(segs)
        plan = _WritePlan(stack=_stacked(merged), merged=merged,
                          src=src, mask=mask, identity=identity)
        if len(self._write_plans) > 64:    # evict least-recently-used
            self._write_plans.pop(next(iter(self._write_plans)))
        self._write_plans[sig] = plan
        return plan

    def snapshot(self, coll_id: int, data) -> np.ndarray:
        """Validate one logical payload and return an OWNED host copy (the
        runtime's submit-time staging must capture the value at call
        time, not at flush time)."""
        data = np.ravel(data)
        want = int(self.t.in_log[coll_id])
        if data.size != want:
            raise ValueError(
                f"collective {coll_id} input: got {data.size} elems, "
                f"registered logical size is {want}")
        return np.array(data, dtype=self._host_dtype)   # always copies

    def write(self, state: DaemonState, items,
              owned: bool = False) -> DaemonState:
        """items: iterable of ``(rank, coll_id, data, base_in_off)``.
        Logical payloads land at their padded positions, pads are zeroed:
        one host-to-device copy, then in-place slice copies into
        ``heap_in``.  ``owned=True`` skips the defensive copy of payloads
        already snapshotted at submit time."""
        items = list(items)
        if not items:
            return state
        datas = [data if owned else self.snapshot(cid, data)
                 for _, cid, data, _ in items]
        # Stable (rank, base) sort: duplicate-region writes keep caller
        # order (last write wins) among themselves.
        order = sorted(range(len(items)),
                       key=lambda i: (items[i][0], items[i][3]))
        plan = self._write_plan(
            tuple((items[i][0], items[i][1], items[i][3]) for i in order))
        vals = [datas[i] for i in order]
        vals = vals[0] if len(vals) == 1 else np.concatenate(vals)
        if plan.identity:
            packed = np.ascontiguousarray(vals)
        else:
            packed = vals[plan.src]
            packed[~plan.mask] = 0
        self.flush_writes += 1
        self.flush_bytes += packed.nbytes
        if isinstance(state, ShardedState):
            self._write_sharded(state, packed, plan)
            return state
        heap = state.heap_in
        dev_vals = torch.from_numpy(packed).to(heap.device).to(heap.dtype)
        _copy_segments(heap, dev_vals, plan.stack, plan.merged)
        return state

    def _write_sharded(self, state: ShardedState, packed: np.ndarray,
                       plan: _WritePlan) -> None:
        """The mesh's write: each rank's rows go host-to-device onto that
        rank's device only (one copy per rank), then into its heap."""
        stack, merged = plan.stack, plan.merged
        if (stack is not None and stack[0] == 0
                and len(merged) == self.cfg.n_ranks):
            self.sharded_flushes += 1
        by_rank: dict = {}
        o = 0
        for rank, off, span in merged:
            by_rank.setdefault(rank, []).append((o, off, span))
            o += span
        for rank, segs in by_rank.items():
            heap = state.shards[rank].heap_in
            rows = np.concatenate([packed[o:o + span] for o, _, span in segs])
            vals = torch.from_numpy(rows).to(heap.device).to(heap.dtype)
            i = 0
            for _, off, span in segs:
                heap[0, off:off + span].copy_(vals[i:i + span])
                i += span

    # -- reads -----------------------------------------------------------
    def _read_plan(self, sig) -> _ReadPlan:
        plan = self._read_plans.pop(sig, None)
        if plan is not None:
            self._read_plans[sig] = plan     # touch: LRU re-insert
            return plan
        t = self.t
        segs, slot_by_key = [], {}
        pos = 0
        for rank, cid, base in sig:
            span = int(t.out_span[cid])
            segs.append((int(rank), int(base), span))
            m = t.stage_out_map[cid]
            identity = bool((m == np.arange(m.size)).all())
            slot_by_key[(rank, cid, base)] = (
                pos, m.size, None if identity else m)
            pos += span
        plan = _ReadPlan(merged=_merge_segments(segs),
                         slot_by_key=slot_by_key)
        if len(self._read_plans) > 64:     # evict least-recently-used
            self._read_plans.pop(next(iter(self._read_plans)))
        self._read_plans[sig] = plan
        return plan

    def read(self, state: DaemonState, keys) -> dict:
        """keys: iterable of ``(rank, coll_id, base_out_off)``.  Returns
        ``{(rank, coll_id): logical output}`` as owned numpy arrays."""
        keys = list(keys)
        if not keys:
            return {}
        plan = self._read_plan(
            tuple(sorted(keys, key=lambda k: (k[0], k[2]))))
        if isinstance(state, ShardedState):
            # Each rank's segments leave its own device in one copy.
            by_rank: dict = {}
            for rank, off, span in plan.merged:
                by_rank.setdefault(rank, []).append(
                    state.shards[rank].heap_out[0, off:off + span])
            packed = np.concatenate([_to_host(parts)
                                     for parts in by_rank.values()])
        else:
            heap = state.heap_out
            packed = _to_host([heap[rank, off:off + span]
                               for rank, off, span in plan.merged])
        out = {}
        for rank, cid, base in keys:
            pos, n, unpad = plan.slot_by_key[(rank, cid, base)]
            if unpad is None:
                out[(rank, cid)] = packed[pos:pos + n].copy()
            else:
                out[(rank, cid)] = packed[pos + unpad]
        return out
