"""Collective algorithm registry: the per-kind ring program builders.

PyTorch port of the ring half of ``repro.core.algos``.  The builders are
registered under ``("ring", kind)`` keys for all seven collective kinds;
:func:`build_ring_program` is the registry-backed entry point and
``primitives.build_program`` delegates here.

The composite plans of the reference (two_level, torus, hybrid, tree,
``CompositePlan``) and the cost model behind ``algo="auto"`` are not ported
yet (ROADMAP.md, "Modules to port", item 4): :func:`select_algo` resolves
``"ring"`` only and raises ``NotImplementedError`` for anything else.
"""
from __future__ import annotations

from typing import Callable, Optional

from .primitives import CollKind, Prim

# (algo_name, kind) -> builder(member_idx, group_size, root_idx) -> program.
ALGO_BUILDERS: dict = {}

COMPOSITE_TODO = ("composite algorithms and algo='auto' are not ported yet "
                  "(ROADMAP.md, 'Modules to port', item 4: composite "
                  "collectives + auto-tuning)")


def register_algo(algo: str, kind: CollKind):
    """Decorator: register a per-rank program builder for (algo, kind)."""

    def deco(fn: Callable[[int, int, int], list]):
        ALGO_BUILDERS[(algo, kind)] = fn
        return fn

    return deco


@register_algo("ring", CollKind.ALL_REDUCE)
def _ring_all_reduce(m: int, R: int, root: int) -> list:
    # Phase 1 (reduce-scatter): chunk c starts at rank c; at step s rank r
    # handles chunk (r - s) mod R; partial completes at step R-1.
    prog = [(Prim.SEND, m)]
    for s in range(1, R - 1):
        prog.append((Prim.RECV_REDUCE_SEND, (m - s) % R))
    prog.append((Prim.RECV_REDUCE_COPY_SEND, (m - (R - 1)) % R))
    # Phase 2 (all-gather): fully-reduced chunks circulate once more.
    for s in range(R, 2 * R - 2):
        prog.append((Prim.RECV_COPY_SEND, (m - s) % R))
    prog.append((Prim.RECV, (m + 2) % R))
    return prog


@register_algo("ring", CollKind.ALL_GATHER)
def _ring_all_gather(m: int, R: int, root: int) -> list:
    prog = [(Prim.COPY_SEND, m)]
    for s in range(1, R - 1):
        prog.append((Prim.RECV_COPY_SEND, (m - s) % R))
    prog.append((Prim.RECV, (m + 1) % R))
    return prog


@register_algo("ring", CollKind.REDUCE_SCATTER)
def _ring_reduce_scatter(m: int, R: int, root: int) -> list:
    # Chunk c finalizes at rank c after R-1 hops, so it starts at c+1.
    prog = [(Prim.SEND, (m - 1) % R)]
    for s in range(1, R - 1):
        prog.append((Prim.RECV_REDUCE_SEND, (m - s - 1) % R))
    prog.append((Prim.RECV_REDUCE_COPY, m))
    return prog


@register_algo("ring", CollKind.BROADCAST)
def _ring_broadcast(m: int, R: int, root: int) -> list:
    d = (m - root) % R
    prog = []
    for k in range(R):  # pipeline the R chunks down the chain
        if d == 0:
            prog.append((Prim.COPY_SEND, k))
        elif d == R - 1:
            prog.append((Prim.RECV, k))
        else:
            prog.append((Prim.RECV_COPY_SEND, k))
    return prog


@register_algo("ring", CollKind.REDUCE)
def _ring_reduce(m: int, R: int, root: int) -> list:
    # R >= 2 here: single-member groups early-return a COPY in
    # build_ring_program, so the chain roles below are total.
    d = (m - root) % R
    prog = []
    for k in range(R):
        if d == 1:
            prog.append((Prim.SEND, k))
        elif d == 0:
            prog.append((Prim.RECV_REDUCE_COPY, k))
        else:
            prog.append((Prim.RECV_REDUCE_SEND, k))
    return prog


@register_algo("ring", CollKind.ALL_TO_ALL)
def _ring_all_to_all(m: int, R: int, root: int) -> list:
    # Personalized exchange over the ring with member-indexed chunks:
    # phase s in 1..R-1 walks every (origin -> origin + s) pair s hops
    # down the ring — the origin SENDs its input chunk for member (m + s),
    # intermediates forward with the heap-inert RECV_SEND, the
    # destination's final RECV lands it in output chunk (m - s).
    prog = [(Prim.COPY, m)]
    for s in range(1, R):
        prog.append((Prim.SEND, (m + s) % R))
        for t in range(1, s):
            prog.append((Prim.RECV_SEND, (m + s - t) % R))
        prog.append((Prim.RECV, (m - s) % R))
    return prog


@register_algo("ring", CollKind.ALL_TO_ALL_RAGGED)
def _ring_all_to_all_ragged(m: int, R: int, root: int) -> list:
    # Distance-indexed chunks: input chunk s holds the payload for member
    # (m + s), output chunk s the payload from member (m - s), so the
    # program and the ragged stage maps are rank-independent.
    prog = [(Prim.COPY, 0)]
    for s in range(1, R):
        prog.append((Prim.SEND, s))
        for t in range(1, s):
            prog.append((Prim.RECV_SEND, s))
        prog.append((Prim.RECV, s))
    return prog


def build_ring_program(
    kind: CollKind, member_idx: int, group_size: int, root_idx: int = 0,
    algo: str = "ring",
) -> list:
    """Per-rank primitive sequence ``[(prim, chunk_idx), ...]`` from the
    algorithm registry.  Ring algorithm, Simple protocol (paper Sec. 5)."""
    if group_size == 1:
        # Degenerate single-member group: a local copy.
        return [(Prim.COPY, 0)]
    try:
        builder = ALGO_BUILDERS[(algo, CollKind(kind))]
    except (KeyError, ValueError):
        known = sorted({f"({a}, {CollKind(k).name})"
                        for a, k in ALGO_BUILDERS})
        raise ValueError(
            f"no registered program builder for algo={algo!r}, "
            f"kind={kind!r}; registered: {known}") from None
    return builder(member_idx, group_size, root_idx)


def select_algo(algo: str, kind: CollKind, n_elems: int, group_size: int,
                hierarchy: Optional[tuple] = None, cfg=None,
                model=None) -> str:
    """Resolve the registration algorithm.  Only the flat ring is ported;
    every other name (including ``"auto"``) raises NotImplementedError."""
    if algo != "ring":
        raise NotImplementedError(f"algo={algo!r}: {COMPOSITE_TODO}")
    return algo
