"""Collective algorithm registry + the composite-collective IR.

PyTorch port of ``repro.core.algos``, pure numpy and host-side like the
reference.  Two layers:

* **Algorithm registry** — the per-kind ring program builders, registered
  under ``("ring", kind)`` keys for all seven collective kinds;
  :func:`build_ring_program` is the registry-backed entry point and
  ``primitives.build_program`` delegates here.
* **CompositePlan IR** — a logical collective over a ``G x N`` rank grid
  lowered into a CHAIN of ring sub-collectives over derived
  sub-communicators (two_level, torus and hybrid all-reduce, tree
  broadcast and reduce, two-level all-to-all).  The chain edges become the
  registration-time successor and relink tables (``tables.py``) that let
  the daemon advance a chain on the device in the same superstep its
  predecessor completes.

Chained sub-collectives are exactly the inter-collective dependencies the
paper warns about (circular collective dependency, Sec. 1): stage k+1 on
one rank waits for stage k on OTHER ranks.  The scheduler's preemption
keeps composed chains deadlock-free the same way it keeps independently
submitted collectives deadlock-free.

Adding an algorithm: write ``plan_<name>(members, hierarchy, n_elems,
root)`` returning a CompositePlan whose adjacent stages satisfy
``out_log(stage k) == in_log(stage k+1)`` (asserted at registration),
register it with ``@register_plan(name, kind)`` and list it in
:data:`AUTO_CANDIDATES` so ``algo="auto"`` can pick it.

``select_algo("auto", ...)`` ranks the candidates with the port's own
alpha-beta-gamma cost model (:mod:`repro_torch.core.costmodel`), fitted to
plans timed on the card (``chip_smoke.py``'s algos sweep) and persisted in
``BENCH_torch_calibration.json``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from .primitives import CollKind, Prim

# (algo_name, kind) -> builder(member_idx, group_size, root_idx) -> program.
ALGO_BUILDERS: dict = {}

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


# ---------------------------------------------------------------------------
# composite plans (multi-communicator chained sub-collectives)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubCollective:
    """One stage of a composite plan: an ordinary ring collective over a
    PARTITIONED sub-communicator (disjoint rings sharing one lane)."""

    kind: CollKind
    members: tuple          # flat rank tuple; consecutive ``ring_size``
                            # runs are the disjoint rings of this stage
    ring_size: int
    n_elems: int            # logical element count of this stage
    root: int = 0
    # Stage-input permutation (CollectiveSpec.in_perm): position of each
    # chain-logical element j inside THIS stage's input layout.  The
    # chain relink composes it with the predecessor's output map, which
    # is how the two-level a2a gets its inter-stage granule transposes
    # for free (no shuffle stage, no extra heap traffic).
    in_perm: tuple = ()


@dataclasses.dataclass(frozen=True)
class CompositePlan:
    """A logical collective lowered to a chain of sub-collectives.

    ``stages[k+1]`` consumes ``stages[k]``'s logical output; the tables
    layer turns each edge into a registration-time heap relink map and a
    ``next_coll`` successor entry, so the daemon advances the whole chain
    on device.  Logical I/O addresses only the endpoints: payloads stage
    into ``stages[0]``'s input region, results read from ``stages[-1]``'s
    output region.
    """

    kind: CollKind          # the logical collective the chain implements
    n_elems: int
    hierarchy: tuple        # (G groups, N ranks per group)
    stages: tuple           # tuple[SubCollective, ...]


def default_hierarchy(R: int) -> tuple:
    """(G, N) with G * N == R and N the largest divisor <= sqrt(R) —
    the most square grid, which minimizes the two-level latency term
    N + (2G - 1) + N.  Primes fall back to (R, 1)."""
    best = 1
    for n in range(2, int(math.isqrt(R)) + 1):
        if R % n == 0:
            best = n
    return (R // best, best)


def _grid(members: Sequence[int], hierarchy: tuple) -> list:
    """Row-major ``G x N`` grid of the member ranks; validates tiling."""
    G, N = hierarchy
    R = len(members)
    if G * N != R:
        raise ValueError(f"hierarchy {hierarchy} does not tile the "
                         f"{R}-member communicator (G * N != {R})")
    members = tuple(members)
    return [members[g * N:(g + 1) * N] for g in range(G)]


def plan_two_level(kind: CollKind, members: Sequence[int],
                   hierarchy: tuple, n_elems: int) -> CompositePlan:
    """Lower a logical all-reduce over a ``G x N`` rank grid into the
    two-level chain (The Big Send-off, PAPERS.md):

      1. intra-group REDUCE_SCATTER over each group's N-ring: member m of
         group g ends up owning chunk m of the group-local sum;
      2. inter-group ALL_REDUCE over the G chunk owners of each position m
         (one G-ring per chunk position): chunk m becomes globally reduced
         everywhere;
      3. intra-group ALL_GATHER over the N-rings: every rank reassembles
         the full globally-reduced payload.

    ``members`` is the logical communicator's ring order, reshaped
    row-major: group g = members[g*N : (g+1)*N].
    """
    if kind != CollKind.ALL_REDUCE:
        raise ValueError(
            f"two_level lowering is defined for ALL_REDUCE only, got "
            f"{CollKind(kind)!r} (register other kinds with algo='ring')")
    G, N = hierarchy
    groups = _grid(members, hierarchy)
    # Inter-group rings: position m's chunk owners across all groups.
    owners = [tuple(groups[g][m] for g in range(G)) for m in range(N)]
    intra = tuple(r for grp in groups for r in grp)          # == members
    inter = tuple(r for ring in owners for r in ring)
    chunk = -(-n_elems // N)                                 # ceil
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.REDUCE_SCATTER, intra, N, n_elems),
            SubCollective(CollKind.ALL_REDUCE, inter, G, chunk),
            SubCollective(CollKind.ALL_GATHER, intra, N, n_elems),
        ))


def plan_torus(kind: CollKind, members: Sequence[int], hierarchy: tuple,
               n_elems: int, root: int = 0) -> CompositePlan:
    """2D-torus all-reduce: replace two_level's inter ALL_REDUCE with an
    inter REDUCE_SCATTER + ALL_GATHER pair.  One more latency step
    (``2N + 2G`` vs ``2N + 2G - 1``) but each inter primitive step moves
    a chunk a further factor G smaller — the right trade when the
    inter-group lane is bandwidth-starved (cfg.bandwidth_groups skew).

    Chain-edge exactness: stage logical sizes compose as
    ``n -> cl1 = ceil(n/N) -> cl2 = ceil(cl1/G) -> cl1 -> n`` using the
    SAME ceil at producer and consumer, so every edge's
    ``out_log == in_log`` holds for ragged payloads too."""
    if kind != CollKind.ALL_REDUCE:
        raise ValueError(
            f"torus lowering is defined for ALL_REDUCE only, got "
            f"{CollKind(kind)!r}")
    G, N = hierarchy
    groups = _grid(members, hierarchy)
    owners = [tuple(groups[g][m] for g in range(G)) for m in range(N)]
    intra = tuple(r for grp in groups for r in grp)
    inter = tuple(r for ring in owners for r in ring)
    cl1 = -(-n_elems // N)                                   # ceil
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.REDUCE_SCATTER, intra, N, n_elems),
            SubCollective(CollKind.REDUCE_SCATTER, inter, G, cl1),
            SubCollective(CollKind.ALL_GATHER, inter, G, cl1),
            SubCollective(CollKind.ALL_GATHER, intra, N, n_elems),
        ))


def plan_hybrid(kind: CollKind, members: Sequence[int], hierarchy: tuple,
                n_elems: int, root: int = 0) -> CompositePlan:
    """Pipelined ring+tree all-reduce: intra REDUCE to each group's
    leader (grid column ``m0``), leader-ring ALL_REDUCE over the FULL
    payload, intra BROADCAST back out.  Latency ``N + (2G - 1) + N``
    with no payload split across stages — competitive at latency-bound
    sizes, deliberately bandwidth-hungry on the inter lane (the cost
    model learns to avoid it when skew makes that lane scarce).

    Non-leader ranks participate only in stages 0 and 2: their chains
    skip the leader ring (per-rank successor maps, tables layer)."""
    if kind != CollKind.ALL_REDUCE:
        raise ValueError(
            f"hybrid lowering is defined for ALL_REDUCE only, got "
            f"{CollKind(kind)!r}")
    G, N = hierarchy
    g0, m0 = divmod(root, N)
    groups = _grid(members, hierarchy)
    leaders = tuple(groups[g][m0] for g in range(G))
    intra = tuple(r for grp in groups for r in grp)
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.REDUCE, intra, N, n_elems, root=m0),
            SubCollective(CollKind.ALL_REDUCE, leaders, G, n_elems),
            SubCollective(CollKind.BROADCAST, intra, N, n_elems, root=m0),
        ))


def plan_two_level_alltoall(kind: CollKind, members: Sequence[int],
                            hierarchy: tuple, n_elems: int,
                            root: int = 0) -> CompositePlan:
    """Hierarchical all-to-all over a ``G x N`` rank grid: an intra-group
    exchange that gathers, per rank, everything its group-column peers
    hold for the OTHER groups, then an inter-group exchange across the
    grid columns that delivers it — a gather -> leader exchange ->
    scatter collapsed into two full-membership stages (every rank is its
    own leader for its slice, so no scatter stage and no G-fold leader
    bottleneck; supersteps drop from the flat ring's ``1 + (R-1)(R+2)/2``
    to the two stages' ``a2a_len(N) + a2a_len(G)``).

    Correctness hinges on the two ``in_perm`` granule transposes: with
    per-pair granule size ``c = n / R`` (n must divide; ``algo="auto"``
    silently drops this plan otherwise, explicit registration raises),
    writing a destination as ``(g', j1)`` and the rank as ``(g, i)``:

      * stage A (intra, one N-ring per group, ring index ``i``) must
        exchange on the DESTINATION COLUMN ``j1``, so its in_perm maps
        the user granule ``d = g'·N + j1`` to stage position
        ``j1·G + g'`` — after the exchange, rank (g, i) holds, for every
        origin column j1 of its own group, the payloads of rank (g, j1)
        for all of column i's ranks, granule order ``o1·G + g'``.
      * stage B (inter, one G-ring per grid column, ring index ``g``)
        exchanges on the destination GROUP, so its in_perm transposes
        ``o1·G + g'`` to stage position ``g'·N + o1``.

    The final output granule ``o2·N + o1`` of rank (g, i) is then the
    payload from global rank ``o2·N + o1`` — the exact absolute
    origin-major layout the flat ring produces, which is what lets
    ``algo="auto"`` swap the two freely and the bench compare them on
    identical submits."""
    if kind != CollKind.ALL_TO_ALL:
        raise ValueError(
            f"two_level all-to-all lowering is defined for ALL_TO_ALL "
            f"only, got {CollKind(kind)!r} (the ragged variant is "
            f"flat-ring only: per-distance sizes do not survive the "
            f"granule transposes)")
    G, N = hierarchy
    groups = _grid(members, hierarchy)
    R = G * N
    if n_elems % R != 0:
        raise ValueError(
            f"two_level all-to-all needs n_elems divisible by the group "
            f"size for exact granule transposes (n_elems={n_elems}, "
            f"R={R}); use algo='ring' for ragged totals")
    c = n_elems // R
    intra = tuple(r for grp in groups for r in grp)          # row-major
    inter = tuple(groups[g][i] for i in range(N) for g in range(G))
    j = np.arange(n_elems, dtype=np.int64)
    u, d = j % c, j // c
    gq, j1 = divmod(d, N)
    perm_a = (j1 * G + gq) * c + u
    o1, gq2 = divmod(j // c, G)
    perm_b = (gq2 * N + o1) * c + (j % c)
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.ALL_TO_ALL, intra, N, n_elems,
                          in_perm=tuple(map(int, perm_a))),
            SubCollective(CollKind.ALL_TO_ALL, inter, G, n_elems,
                          in_perm=tuple(map(int, perm_b))),
        ))


def plan_tree_broadcast(kind: CollKind, members: Sequence[int],
                        hierarchy: tuple, n_elems: int, root: int = 0
                        ) -> CompositePlan:
    """Tree broadcast over the grid: root's payload hops the leader ring
    (grid column ``m0`` of the root), then every group's leader fans out
    over its intra ring — ``G + N`` latency steps vs the flat ring's
    ``R``.  Non-leader ranks participate only in the intra stage."""
    if kind != CollKind.BROADCAST:
        raise ValueError(
            f"tree broadcast lowering got {CollKind(kind)!r}")
    G, N = hierarchy
    g0, m0 = divmod(root, N)
    groups = _grid(members, hierarchy)
    leaders = tuple(groups[g][m0] for g in range(G))
    intra = tuple(r for grp in groups for r in grp)
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.BROADCAST, leaders, G, n_elems,
                          root=g0),
            SubCollective(CollKind.BROADCAST, intra, N, n_elems,
                          root=m0),
        ))


def plan_tree_reduce(kind: CollKind, members: Sequence[int],
                     hierarchy: tuple, n_elems: int, root: int = 0
                     ) -> CompositePlan:
    """Tree reduce: mirror of the tree broadcast — every group reduces
    onto its leader (the root's grid column ``m0``), then the leader
    ring reduces onto the root's group leader, i.e. the root itself."""
    if kind != CollKind.REDUCE:
        raise ValueError(f"tree reduce lowering got {CollKind(kind)!r}")
    G, N = hierarchy
    g0, m0 = divmod(root, N)
    groups = _grid(members, hierarchy)
    leaders = tuple(groups[g][m0] for g in range(G))
    intra = tuple(r for grp in groups for r in grp)
    return CompositePlan(
        kind=kind, n_elems=n_elems, hierarchy=(G, N),
        stages=(
            SubCollective(CollKind.REDUCE, intra, N, n_elems, root=m0),
            SubCollective(CollKind.REDUCE, leaders, G, n_elems, root=g0),
        ))


# (algo_name, kind) -> plan builder(members, hierarchy, n_elems, root).
PLAN_BUILDERS: dict = {
    ("two_level", CollKind.ALL_REDUCE):
        lambda members, hier, n, root=0: plan_two_level(
            CollKind.ALL_REDUCE, members, hier, n),
    ("torus", CollKind.ALL_REDUCE):
        lambda members, hier, n, root=0: plan_torus(
            CollKind.ALL_REDUCE, members, hier, n, root),
    ("hybrid", CollKind.ALL_REDUCE):
        lambda members, hier, n, root=0: plan_hybrid(
            CollKind.ALL_REDUCE, members, hier, n, root),
    ("tree", CollKind.BROADCAST):
        lambda members, hier, n, root=0: plan_tree_broadcast(
            CollKind.BROADCAST, members, hier, n, root),
    ("tree", CollKind.REDUCE):
        lambda members, hier, n, root=0: plan_tree_reduce(
            CollKind.REDUCE, members, hier, n, root),
    ("two_level", CollKind.ALL_TO_ALL):
        lambda members, hier, n, root=0: plan_two_level_alltoall(
            CollKind.ALL_TO_ALL, members, hier, n),
}


def register_plan(algo: str, kind: CollKind):
    """Decorator: register a composite plan builder for (algo, kind)."""

    def deco(fn):
        PLAN_BUILDERS[(algo, CollKind(kind))] = fn
        return fn

    return deco


# Candidate plans ``algo="auto"`` ranks per kind (flat ring is always a
# candidate; plans needing a non-degenerate grid are filtered at select
# time).  Order breaks cost ties: earlier wins.
AUTO_CANDIDATES: dict = {
    CollKind.ALL_REDUCE: ("ring", "two_level", "torus", "hybrid"),
    CollKind.BROADCAST: ("ring", "tree"),
    CollKind.REDUCE: ("ring", "tree"),
    CollKind.ALL_GATHER: ("ring",),
    CollKind.REDUCE_SCATTER: ("ring",),
    CollKind.ALL_TO_ALL: ("ring", "two_level"),
    CollKind.ALL_TO_ALL_RAGGED: ("ring",),
}


def build_plan(algo: str, kind: CollKind, members: Sequence[int],
               hierarchy: tuple, n_elems: int, root: int = 0
               ) -> CompositePlan:
    """Dispatch a composite lowering from the plan registry."""
    try:
        builder = PLAN_BUILDERS[(algo, CollKind(kind))]
    except KeyError:
        raise ValueError(
            f"no registered composite plan for algo={algo!r}, "
            f"kind={CollKind(kind)!r} (registered: "
            f"{sorted(set(a for a, _ in PLAN_BUILDERS))})")
    return builder(tuple(members), tuple(hierarchy), n_elems, root)


def select_algo(algo: str, kind: CollKind, n_elems: int, group_size: int,
                hierarchy: Optional[tuple] = None, cfg=None,
                model=None) -> str:
    """Resolve ``"auto"`` to the concrete algorithm with the lowest
    PREDICTED WALL-CLOCK under the measured α-β-γ cost model
    (:mod:`repro_torch.core.costmodel`).

    Explicit algorithm names pass through unchanged.  ``"auto"`` ranks
    the :data:`AUTO_CANDIDATES` of the kind: per candidate the model
    predicts ``α·supersteps + β·bytes_on_wire + γ·n_stages`` from the
    plan's stage structure, the config's slicing geometry and the
    bandwidth-skew lane caps; (α, β, γ) come from ``model`` (default:
    the persisted ``BENCH_torch_calibration.json`` fit, falling back to
    conservative defaults when absent).  Composite
    candidates are dropped when the grid is degenerate (G or N == 1 —
    prime groups) — a lone flat ring short-circuits without consulting
    the model, so flat-only workloads never touch the calibration file.
    """
    if algo != "auto":
        return algo
    if hierarchy is not None:
        G, N = hierarchy
        # A caller-provided grid that does not tile the group is a bug,
        # not a selection hint: silently downgrading to the flat ring
        # would hide the typo (the explicit composite path raises the
        # same error via _grid).
        if G * N != group_size:
            raise ValueError(
                f"hierarchy {hierarchy} does not tile the "
                f"{group_size}-member communicator (G * N != {group_size})")
    else:
        G, N = default_hierarchy(group_size)
    try:
        pool = AUTO_CANDIDATES[CollKind(kind)]
    except (KeyError, ValueError):
        known = sorted(CollKind(k).name for k in AUTO_CANDIDATES)
        raise ValueError(
            f"algo='auto' has no candidate set for collective kind "
            f"{kind!r}; registered kinds: {known}") from None
    candidates = [
        a for a in pool
        if a == "ring" or (G > 1 and N > 1
                           and (a, CollKind(kind)) in PLAN_BUILDERS)
    ]
    if len(candidates) == 1:
        return candidates[0]
    from .costmodel import CostModel, plan_features

    if model is None:
        model = CostModel.load()
    costs = {}
    for a in candidates:
        try:
            costs[a] = model.predict(
                plan_features(cfg, kind, n_elems, group_size, (G, N), a))
        except ValueError:
            # Plan not constructible for this payload/grid (e.g. the
            # two-level a2a's exact-divisibility requirement): drop the
            # candidate rather than fail selection — the flat ring is
            # always constructible.
            continue
    return min((a for a in candidates if a in costs),
               key=lambda a: costs[a])
