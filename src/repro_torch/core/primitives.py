"""Collective primitives and per-rank primitive programs (paper Sec. 2.3).

Every commonly used collective is a per-rank sequence of *primitives*, each a
fusion of the four basic actions ``send / recv / reduce / copy`` over four
buffers (send/recv buffer, send/recv connector).  A rank executes its
sequence chunk-by-chunk, slice-by-slice; the (chunk, primitive, slice)
triple is the *dynamic context* that makes collectives preemptible.

PyTorch port of ``repro.core.primitives``: the host-side registry is plain
Python/numpy and identical to the reference; :func:`burst_quota` works on
tensors.
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Prim(enum.IntEnum):
    """Primitive vocabulary (paper Sec. 2.3)."""

    NULL = 0                    # padding past the end of a program
    COPY = 1                    # local copy (degenerate 1-rank groups)
    SEND = 2
    RECV = 3
    COPY_SEND = 4
    RECV_COPY_SEND = 5
    RECV_REDUCE_SEND = 6
    RECV_REDUCE_COPY = 7
    RECV_REDUCE_COPY_SEND = 8
    # Pure relay: receive a slice burst and forward it without touching
    # the output heap (the all-to-all relay hop).
    RECV_SEND = 9


# Action-fusion flag table: prim -> (recv, send, reduce, copy, reads_input).
# ``reads_input`` marks prims whose value involves the local send buffer.
_FLAGS = {
    Prim.NULL: (0, 0, 0, 0, 0),
    Prim.COPY: (0, 0, 0, 1, 1),
    Prim.SEND: (0, 1, 0, 0, 1),
    Prim.RECV: (1, 0, 0, 1, 0),
    Prim.COPY_SEND: (0, 1, 0, 1, 1),
    Prim.RECV_COPY_SEND: (1, 1, 0, 1, 0),
    Prim.RECV_REDUCE_SEND: (1, 1, 1, 0, 1),
    Prim.RECV_REDUCE_COPY: (1, 0, 1, 1, 1),
    Prim.RECV_REDUCE_COPY_SEND: (1, 1, 1, 1, 1),
    Prim.RECV_SEND: (1, 1, 0, 0, 0),
}

# Dense lookup arrays indexed by Prim value.
PRIM_RECV = np.array([_FLAGS[Prim(i)][0] for i in range(len(Prim))], np.int32)
PRIM_SEND = np.array([_FLAGS[Prim(i)][1] for i in range(len(Prim))], np.int32)
PRIM_REDUCE = np.array([_FLAGS[Prim(i)][2] for i in range(len(Prim))], np.int32)
PRIM_COPY = np.array([_FLAGS[Prim(i)][3] for i in range(len(Prim))], np.int32)
PRIM_READS_IN = np.array([_FLAGS[Prim(i)][4] for i in range(len(Prim))], np.int32)


class CollKind(enum.IntEnum):
    ALL_REDUCE = 0
    ALL_GATHER = 1
    REDUCE_SCATTER = 2
    BROADCAST = 3
    REDUCE = 4
    # Personalized exchange: member m's input chunk d is the payload FOR
    # member d; its output chunk o is the payload FROM member o.
    ALL_TO_ALL = 5
    # Capacity-dropped variant with per-DISTANCE valid sizes.
    ALL_TO_ALL_RAGGED = 6


def build_program(
    kind: CollKind, member_idx: int, group_size: int, root_idx: int = 0
) -> list[tuple[Prim, int]]:
    """Per-rank primitive sequence ``[(prim, chunk_idx), ...]``.

    ``member_idx`` is the rank's position in the communicator's ring order;
    data flows member m -> member (m+1) % group_size.  Ring algorithm,
    Simple protocol (paper Sec. 5 Benchmarks); the per-kind builders live
    in :mod:`repro_torch.core.algos`.
    """
    from .algos import build_ring_program

    return build_ring_program(kind, member_idx, group_size, root_idx)


# Ring all-to-all: step 0 is the local COPY, then phase s in 1..R-1 moves
# every (origin -> origin+s) pair s hops down the ring: one SEND, s-1
# relay forwards (RECV_SEND), one final RECV.
def _ring_a2a_len(group_size: int) -> int:
    return 1 + (group_size - 1) * (group_size + 2) // 2


_PROGRAM_LEN: dict = {
    CollKind.ALL_REDUCE: lambda R: 2 * R - 1,
    CollKind.ALL_GATHER: lambda R: R,
    CollKind.REDUCE_SCATTER: lambda R: R,
    CollKind.BROADCAST: lambda R: R,
    CollKind.REDUCE: lambda R: R,
    CollKind.ALL_TO_ALL: _ring_a2a_len,
    CollKind.ALL_TO_ALL_RAGGED: _ring_a2a_len,
}

# I/O indexing: whether the collective's send/recv *buffer* is indexed by the
# chunk id (True) or holds a single chunk addressed by slice only (False).
_IO_CHUNKED: dict = {
    CollKind.ALL_REDUCE: (True, True),
    CollKind.ALL_GATHER: (False, True),   # in: own chunk; out: all chunks
    CollKind.REDUCE_SCATTER: (True, False),
    CollKind.BROADCAST: (True, True),
    CollKind.REDUCE: (True, True),
    CollKind.ALL_TO_ALL: (True, True),    # per-destination in, per-origin out
    CollKind.ALL_TO_ALL_RAGGED: (True, True),
}


def _registered(kind, table: dict, what: str):
    """Registry lookup with a loud, named error for unknown kinds."""
    try:
        return table[CollKind(kind)]
    except (KeyError, ValueError):
        known = sorted(CollKind(k).name for k in table)
        raise ValueError(
            f"{what} has no entry for collective kind {kind!r}; "
            f"registered kinds: {known}") from None


def program_len(kind: CollKind, group_size: int) -> int:
    if group_size == 1:
        return 1
    return _registered(kind, _PROGRAM_LEN, "program_len")(group_size)


def io_chunked(kind: CollKind) -> tuple[bool, bool]:
    return _registered(kind, _IO_CHUNKED, "io_chunked")


@dataclasses.dataclass(frozen=True)
class Communicator:
    """Rank group(s) with fixed ring order, bound to a daemon lane.

    Lane ``l`` on every rank gang-schedules with lane ``l`` on its ring
    peers and owns a private connector channel.  A communicator may be
    PARTITIONED into several disjoint rings of equal size sharing the one
    lane (``ring_size < len(members)``); ``size`` is the RING size.
    """

    comm_id: int
    members: tuple[int, ...]      # global ranks; consecutive ring_size runs
    lane: int
    ring_size: int | None = None  # None: one ring over all members

    def __post_init__(self):
        assert len(set(self.members)) == len(self.members)
        if self.ring_size is not None:
            assert self.ring_size >= 1
            assert len(self.members) % self.ring_size == 0, (
                "members must tile into equal-size rings")

    @property
    def size(self) -> int:
        return (len(self.members) if self.ring_size is None
                else self.ring_size)

    def member_index(self, rank: int) -> int:
        """Position of ``rank`` within ITS ring (ring-local index)."""
        return self.members.index(rank) % self.size

    def rings(self) -> list[tuple[int, ...]]:
        rs = self.size
        return [self.members[i:i + rs]
                for i in range(0, len(self.members), rs)]

    def fwd_perm(self, n_ranks: int) -> np.ndarray:
        """perm[src] = dst for the forward (data) exchange; identity
        off-group.  Each partitioned ring wraps independently."""
        perm = np.arange(n_ranks)
        for ring in self.rings():
            for i, r in enumerate(ring):
                perm[r] = ring[(i + 1) % len(ring)]
        return perm

    def rev_perm(self, n_ranks: int) -> np.ndarray:
        perm = np.arange(n_ranks)
        for ring in self.rings():
            for i, r in enumerate(ring):
                perm[r] = ring[(i - 1) % len(ring)]
        return perm


ReduceOpLike = int


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """Static context of a registered collective (paper Sec. 3.1.1).

    Buffer *addresses* (heap offsets) live here as defaults but may be
    overridden per submission by the SQE (paper Sec. 3.1.2).  The chain
    fields (``next_coll``, ``chain_stage``, ``inherit_prio``, ``in_perm``)
    link the stages of a composite collective (``algos.CompositePlan``).
    """

    coll_id: int
    kind: CollKind
    comm: Communicator
    n_elems: int                  # logical element count (all-reduce size N)
    op: ReduceOpLike = 0          # ReduceOp value
    root: int = 0                 # member index of root (broadcast/reduce)
    in_off: int = 0               # default heap offsets
    out_off: int = 0
    n_slices: int = 1             # slices per chunk PER ROUND (derived)
    n_rounds: int = 1             # primitive-sequence repetitions (derived)
    next_coll: int = -1           # successor collective id (-1: tail/flat)
    chain_stage: int = 0          # 0 = head/standalone
    inherit_prio: bool = True     # successor inherits the live priority
    in_perm: tuple = ()           # logical-input permutation (empty = id)
    # ALL_TO_ALL_RAGGED only: per-distance live element counts.
    chunk_sizes: tuple = ()

    @property
    def group_size(self) -> int:
        return self.comm.size

    def chunk_elems(self, slice_elems: int) -> int:
        return self.n_rounds * self.n_slices * slice_elems

    def padded_elems(self, slice_elems: int) -> int:
        return self.group_size * self.chunk_elems(slice_elems)


def burst_quota(burst, room, recv_avail, send_free, needs_recv, needs_send):
    """Slices a lane may move this superstep (credit-aware gating math).

    Element-wise over lanes (int32 tensors): the burst is bounded by the
    configured width ``burst``, the slices left in the current primitive
    step ``room``, the committed-but-unconsumed writes in the recv
    connector (``recv_avail``) when the primitive receives, and the free
    connector slots (``send_free``) when it sends.  Per-slice credit
    accounting keeps the ``sum(sent - consumed) <= R * (K - 1)``
    ring-capacity invariant of :func:`derive_slicing`.
    """
    q = torch.minimum(torch.as_tensor(burst, dtype=torch.int32,
                                      device=room.device), room)
    q = torch.minimum(q, torch.where(needs_recv, recv_avail, q))
    q = torch.minimum(q, torch.where(needs_send, send_free, q))
    return torch.clamp(q, min=0)


def derive_slicing(n_elems: int, group_size: int, slice_elems: int,
                   conn_depth: int) -> tuple[int, int]:
    """(slices-per-chunk-per-round, rounds).

    Per-round slices are capped at ``conn_depth - 1`` so the connector ring
    can never fill on every edge simultaneously: around a ring,
    sum(sent - consumed) <= R * (K - 1) < R * K, hence at least one edge
    always has both data and capacity — the fused primitives cannot wedge.
    """
    assert conn_depth >= 2, "conn_depth must be >= 2 for pipelining"
    chunk = -(-n_elems // group_size)              # ceil
    total = max(1, -(-chunk // slice_elems))       # ceil: slices per chunk
    cap = conn_depth - 1
    rounds = -(-total // cap)
    per_round = -(-total // rounds)
    return per_round, rounds
