"""Registration-time static tables for the daemon (paper Sec. 3.1.1).

``OCCL registers collectives to be used on each GPU and prepares their meta
information as well as collective context buffer slots before executing
them.``  Registration happens host-side in numpy; the result is a set of
dense arrays indexed by collective id.  Per-rank tables (primitive
programs, membership) carry a leading rank axis.

PyTorch port of ``repro.core.tables``: all numpy, field-for-field equal to
the reference's tables for every registration, composite chains included
(successor, tail and mask tables, the heap relink maps of every chain edge
and the per-rank chain maps of partial-membership plans).
``tables_from_numpy`` in :mod:`repro_torch.core.state` moves them onto a
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .config import OcclConfig
from .primitives import (
    CollKind,
    CollectiveSpec,
    Communicator,
    Prim,
    build_program,
    io_chunked,
    program_len,
)

# Byte width of each supported heap / wire dtype.
_WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclasses.dataclass
class StaticTables:
    """Dense static context for up to C collectives over Rk ranks."""

    # per-collective, rank-independent -----------------------------------
    registered: np.ndarray    # [C] bool
    kind: np.ndarray          # [C] int32
    op: np.ndarray            # [C] int32 (ReduceOp)
    lane: np.ndarray          # [C] int32
    n_steps: np.ndarray       # [C] int32 (per-rank program length; same all ranks)
    n_slices: np.ndarray      # [C] int32 (slices per chunk per round)
    n_rounds: np.ndarray      # [C] int32 (primitive-sequence repetitions)
    group_size: np.ndarray    # [C] int32
    in_chunked: np.ndarray    # [C] int32
    out_chunked: np.ndarray   # [C] int32
    base_in_off: np.ndarray   # [C] int32 (default heap offsets)
    base_out_off: np.ndarray  # [C] int32

    # per-(rank, collective) ----------------------------------------------
    member: np.ndarray        # [Rk, C] bool — rank participates
    prog_kind: np.ndarray     # [Rk, C, S] int32 (Prim)
    prog_chunk: np.ndarray    # [Rk, C, S] int32

    # per-lane ring permutations -----------------------------------------
    lane_caps: np.ndarray     # [L] int32 — max slices a lane moves per
                              #   superstep: burst_slices uniformly, unless
                              #   the bandwidth-skew model
                              #   (cfg.bandwidth_groups) classifies the
                              #   lane's rings as island-crossing (inter)
                              #   or island-local (intra) and caps each
                              #   class (clamped to [1, burst_slices])
    fwd_src: np.ndarray       # [L, Rk] int32 — fwd msg arriving at rank r
                              #   was sent by fwd_src[l, r]
    rev_src: np.ndarray       # [L, Rk] int32 — reverse (credit) exchange
    fwd_perm_pairs: list      # [L] list[(src, dst)] for lax.ppermute
    rev_perm_pairs: list
    # Lanes grouped by identical ring permutation: each group's traffic is
    # fused into ONE stacked ppermute pair per direction in the mesh
    # backend (instead of one ppermute per lane per mailbox field).
    lane_groups: list         # [(lanes: list[int], fwd_pairs, rev_pairs)]
    # Per-ring-group lane-pairing metadata for the packed 16-bit exchange:
    # aligned with ``lane_groups``.  Each entry is ``(packed_cols, pad)`` —
    # the group's [G, B*SL] 16-bit payload rows are zero-padded by ``pad``
    # elements (odd lane) and adjacent element PAIRS are bitcast into
    # ``packed_cols`` i32 lanes, so the payload concatenates with the i32
    # (coll, count) header and rides ONE forward ppermute (2 ppermutes per
    # superstep, same as 32-bit dtypes).  ``None`` when the heap dtype is
    # not 16-bit or ``cfg.packed_16bit`` is off (escape hatch): the
    # exchange falls back to separate header/payload ppermutes.
    lane_group_pack16: list | None  # [(packed_cols: int, pad: int)] | None

    # staging layout (runtime I/O; consumed by staging.StagingEngine) -----
    # The padded chunk layout of every collective is resolved ONCE here, so
    # the per-step pack/unpack transform is a precomputed index map instead
    # of per-call Python chunk loops.  Maps are RELATIVE to the
    # collective's base heap offset, so a per-SQE dynamic offset override
    # is a scalar add at flush time.
    chunk_pad: np.ndarray     # [C] i32 — padded chunk extent (rounds*slices*SL)
    chunk_log: np.ndarray     # [C] i32 — logical chunk elems (ceil(n/G))
    in_log: np.ndarray        # [C] i32 — logical input elems per rank
    out_log: np.ndarray       # [C] i32 — logical output elems per rank
    in_span: np.ndarray       # [C] i32 — padded input extent in the heap
    out_span: np.ndarray      # [C] i32 — padded output extent in the heap
    stage_in_map: list        # [C] np.int32[in_log[c]]: logical j -> rel
                              #   off; every in-span offset NOT in the map
                              #   is a pad position the engine zero-fills
    stage_out_map: list       # [C] np.int32[out_log[c]]: logical j -> rel off

    # composite chains (core/algos.py CompositePlan) ----------------------
    # Successor/chain tables: when collective ``c`` completes on a rank and
    # ``next_coll[c] >= 0``, the daemon enqueues the successor SQE on
    # device in the same superstep; only the chain TAIL emits a CQE.
    next_coll: np.ndarray     # [C] i32 — successor collective id (-1 none)
    chain_stage: np.ndarray   # [C] i32 — stage index within the chain
    chain_tail: np.ndarray    # [C] i32 — tail collective of c's chain
                              #   (self for flat collectives)
    chain_prio_inherit: np.ndarray  # [C] bool — device-enqueued successor
                              #   inherits the predecessor's live priority
    chain_mask: np.ndarray    # [C, C] bool — row c marks every stage of
                              #   c's chain (one-hot for flat colls);
                              #   drives chain-wide inflight set/clear
    # Heap relink maps for the chain hand-off: when stage c completes, the
    # successor's ENTIRE padded input span (base offsets; intermediates
    # are never offset-overridden) is rewritten from c's output region —
    # logical elements gathered via the composed stage maps, pad positions
    # zero-filled (-1 source).  [C, M] with M = max successor in-span over
    # chained collectives; M == 0 when the registration has no chains, so
    # the scheduler skips tracing the relink scatter entirely.
    chain_src: np.ndarray     # [C, M] i32 — absolute heap_out offsets, -1=0
    chain_dst: np.ndarray     # [C, M] i32 — absolute heap_in offsets
                              #   (out-of-range sentinel on unused rows)
    # PER-RANK chain maps: composite stages may cover only a subset of the
    # logical members (tree/hybrid inter stages run on the group leaders),
    # so each rank walks its OWN successor chain — the next stage it
    # participates in — and emits its logical CQE at its own last
    # participating stage.  Full-membership chains (two_level/torus)
    # reduce to the global next_coll/chain_tail row-for-row.
    chain_next: np.ndarray    # [Rk, C] i32 — rank's next participating
                              #   stage after c (-1: c is the rank's tail)
    chain_tail_r: np.ndarray  # [Rk, C] i32 — rank's last participating
                              #   stage of c's chain (self for flat colls
                              #   and for non-members)

    max_steps: int

    @property
    def has_chains(self) -> bool:
        return self.chain_src.shape[1] > 0


def build_tables(
    cfg: OcclConfig,
    comms: list[Communicator],
    specs: list[CollectiveSpec],
) -> StaticTables:
    Rk, C, L = cfg.n_ranks, cfg.max_colls, cfg.max_comms
    assert len(comms) <= L, "more communicators than daemon lanes"
    assert len(specs) <= C, "more collectives than registered slots"
    for s in specs:
        assert s.coll_id < C
        assert s.comm.lane < L

    S = max(
        [program_len(CollKind(s.kind), s.group_size) for s in specs] or [1]
    )

    t = StaticTables(
        registered=np.zeros(C, bool),
        kind=np.zeros(C, np.int32),
        op=np.zeros(C, np.int32),
        lane=np.zeros(C, np.int32),
        n_steps=np.zeros(C, np.int32),
        n_slices=np.ones(C, np.int32),
        n_rounds=np.ones(C, np.int32),
        group_size=np.ones(C, np.int32),
        in_chunked=np.ones(C, np.int32),
        out_chunked=np.ones(C, np.int32),
        base_in_off=np.zeros(C, np.int32),
        base_out_off=np.zeros(C, np.int32),
        member=np.zeros((Rk, C), bool),
        prog_kind=np.full((Rk, C, S), int(Prim.NULL), np.int32),
        prog_chunk=np.zeros((Rk, C, S), np.int32),
        lane_caps=np.full(L, cfg.burst_slices, np.int32),
        fwd_src=np.tile(np.arange(Rk, dtype=np.int32), (L, 1)),
        rev_src=np.tile(np.arange(Rk, dtype=np.int32), (L, 1)),
        fwd_perm_pairs=[[] for _ in range(L)],
        rev_perm_pairs=[[] for _ in range(L)],
        lane_groups=[],
        lane_group_pack16=None,
        chunk_pad=np.zeros(C, np.int32),
        chunk_log=np.zeros(C, np.int32),
        in_log=np.zeros(C, np.int32),
        out_log=np.zeros(C, np.int32),
        in_span=np.zeros(C, np.int32),
        out_span=np.zeros(C, np.int32),
        stage_in_map=[np.zeros(0, np.int32)] * C,
        stage_out_map=[np.zeros(0, np.int32)] * C,
        next_coll=np.full(C, -1, np.int32),
        chain_stage=np.zeros(C, np.int32),
        chain_tail=np.arange(C, dtype=np.int32),
        chain_prio_inherit=np.zeros(C, bool),
        chain_mask=np.eye(C, dtype=bool),
        chain_src=np.zeros((C, 0), np.int32),
        chain_dst=np.zeros((C, 0), np.int32),
        chain_next=np.full((Rk, C), -1, np.int32),
        chain_tail_r=np.tile(np.arange(C, dtype=np.int32), (Rk, 1)),
        max_steps=S,
    )

    for comm in comms:
        t.lane_caps[comm.lane] = _lane_cap(cfg, comm)
        fwd = comm.fwd_perm(Rk)   # perm[src] = dst
        rev = comm.rev_perm(Rk)
        for src in range(Rk):
            t.fwd_src[comm.lane, fwd[src]] = src
            t.rev_src[comm.lane, rev[src]] = src
        t.fwd_perm_pairs[comm.lane] = [
            (int(s), int(fwd[s])) for s in range(Rk)
        ]
        t.rev_perm_pairs[comm.lane] = [
            (int(s), int(rev[s])) for s in range(Rk)
        ]

    # Group lanes by ring-permutation signature; lanes without a
    # communicator (empty pairs) are excluded — their mailbox slots stay
    # zero, which the receiving scheduler reads as count 0.
    by_perm: dict = {}
    for lane in range(L):
        pairs = t.fwd_perm_pairs[lane]
        if not pairs:
            continue
        by_perm.setdefault(tuple(pairs), []).append(lane)
    t.lane_groups = [
        (lanes, list(sig), t.rev_perm_pairs[lanes[0]])
        for sig, lanes in by_perm.items()
    ]
    # Lane-pairing metadata for the packed 16-bit exchange (consumed by
    # daemon._mesh_exchange): pair adjacent 16-bit payload elements of each
    # fused [G, B*SL] group row into i32 lanes; an odd row width gets one
    # zero pad element that the receiver slices off.
    if cfg.packed_16bit and _WIRE_ITEMSIZE[cfg.dtype] == 2:
        width = cfg.burst_slices * cfg.slice_elems
        pad = width % 2
        t.lane_group_pack16 = [((width + pad) // 2, pad)
                               for _ in t.lane_groups]

    for s in specs:
        c = s.coll_id
        kind = CollKind(s.kind)
        inc, outc = io_chunked(kind)
        t.registered[c] = True
        t.kind[c] = int(kind)
        t.op[c] = int(s.op)
        t.lane[c] = s.comm.lane
        t.n_steps[c] = program_len(kind, s.group_size)
        t.n_slices[c] = s.n_slices
        t.n_rounds[c] = s.n_rounds
        t.group_size[c] = s.group_size
        t.in_chunked[c] = int(inc)
        t.out_chunked[c] = int(outc)
        t.base_in_off[c] = s.in_off
        t.base_out_off[c] = s.out_off
        _build_stage_maps(t, c, s, cfg.slice_elems, inc, outc)
        t.next_coll[c] = s.next_coll
        t.chain_stage[c] = s.chain_stage
        t.chain_prio_inherit[c] = bool(s.inherit_prio)
        for rank in s.comm.members:
            m = s.comm.member_index(rank)
            t.member[rank, c] = True
            prog = build_program(kind, m, s.group_size, s.root)
            assert len(prog) == int(t.n_steps[c]), (
                f"collective {c}: {kind.name} builder emitted "
                f"{len(prog)} steps for member {m}, program_len says "
                f"{int(t.n_steps[c])}")
            for step, (prim, chunk) in enumerate(prog):
                t.prog_kind[rank, c, step] = int(prim)
                t.prog_chunk[rank, c, step] = chunk
    _build_chain_tables(t, specs)
    _build_rank_chain_maps(t, specs)
    return t


def _lane_cap(cfg: OcclConfig, comm) -> int:
    """Per-superstep slice cap of a communicator's lane under the
    bandwidth-skew model: inter (any ring hop crosses an island boundary)
    vs intra class caps, clamped to [1, burst_slices]; the uniform burst
    when the model is off or the class cap is 0.  Mirrored for cost
    prediction by costmodel._lane_cap_for."""
    B = cfg.burst_slices
    if cfg.bandwidth_groups <= 1:
        return B
    isl = cfg.n_ranks // cfg.bandwidth_groups
    inter = any(
        ring[i] // isl != ring[(i + 1) % len(ring)] // isl
        for ring in comm.rings() for i in range(len(ring)))
    cap = cfg.inter_burst_cap if inter else cfg.intra_burst_cap
    return max(1, min(B, cap)) if cap > 0 else B


def _build_chain_tables(t: StaticTables, specs: list) -> None:
    """Resolve chain closure (tail ids, chain membership masks) and the
    heap relink maps of every chain edge.

    The relink map of edge ``c -> succ`` rewrites the successor's whole
    padded input span from c's output region by composing the two
    registration-time stage maps: logical element j of the hand-off lives
    at ``base_out_off[c] + stage_out_map[c][j]`` in ``heap_out`` and must
    land at ``base_in_off[succ] + stage_in_map[succ][j]`` in ``heap_in``;
    every other in-span position is a pad the relink zero-fills (source
    -1), so stale heap data can never leak into the successor's slices.
    Offsets are ABSOLUTE: chain intermediates always run at their
    registered base offsets (per-SQE overrides apply only to the logical
    endpoints — the head's input, the tail's output).
    """
    by_id = {s.coll_id: s for s in specs}
    edges = []
    for s in specs:
        c = s.coll_id
        if s.next_coll < 0:
            continue
        succ = by_id.get(s.next_coll)
        assert succ is not None, (
            f"collective {c}: successor {s.next_coll} is not registered")
        assert int(t.out_log[c]) == int(t.in_log[succ.coll_id]), (
            f"chain edge {c} -> {succ.coll_id}: logical sizes differ "
            f"({int(t.out_log[c])} vs {int(t.in_log[succ.coll_id])})")
        edges.append((c, succ.coll_id))
    # Tail closure + chain membership masks (rows identical for every
    # stage of a chain; one-hot + self-tail for flat collectives).
    for s in specs:
        members = _chain_members(by_id, s.coll_id)
        for a in members:
            t.chain_tail[a] = members[-1]
            for b in members:
                t.chain_mask[a, b] = True
    if not edges:
        return
    M = max(int(t.in_span[succ]) for _, succ in edges)
    t.chain_src = np.full((t.chain_mask.shape[0], M), -1, np.int32)
    # Unused rows point the relink at an out-of-heap sentinel (dropped,
    # as the reference's mode='drop' scatter does); they are also gated off
    # by the completion mask.
    t.chain_dst = np.full((t.chain_mask.shape[0], M), 1 << 30, np.int32)
    for c, succ in edges:
        span = int(t.in_span[succ])
        src = np.full(span, -1, np.int32)
        n_log = int(t.in_log[succ])
        src[t.stage_in_map[succ]] = (
            t.base_out_off[c] + t.stage_out_map[c][:n_log])
        t.chain_src[c, :span] = src
        t.chain_dst[c, :span] = t.base_in_off[succ] + np.arange(
            span, dtype=np.int32)


def _build_rank_chain_maps(t: StaticTables, specs: list) -> None:
    """Per-rank successor/tail maps for partial-membership chains.

    A stage of a composite plan may cover only a subset of the logical
    members (tree broadcast's leader ring, hybrid's inter all-reduce), so
    the global ``next_coll`` chain is specialized per rank:
    ``chain_next[r, c]`` is the first stage AFTER c (following next_coll)
    that rank r participates in, and ``chain_tail_r[r, c]`` is r's last
    participating stage of c's whole chain — where r's logical CQE fires
    and where its per-SQE out_off override resolves.  For chains whose
    every stage covers every member both maps equal the global
    next_coll / chain_tail rows, and flat collectives keep the defaults
    (-1 / self), so the scheduler's chain-free semantics are unchanged.
    """
    by_id = {s.coll_id: s for s in specs}
    Rk = t.member.shape[0]
    for s in specs:
        c = s.coll_id
        chain = _chain_members(by_id, c)
        if len(chain) == 1:
            continue
        for rank in range(Rk):
            if not t.member[rank, c]:
                continue
            nxt = -1
            for cand in chain[chain.index(c) + 1:]:
                if t.member[rank, cand]:
                    nxt = cand
                    break
            t.chain_next[rank, c] = nxt
            mine = [a for a in chain if t.member[rank, a]]
            t.chain_tail_r[rank, c] = mine[-1]


def _chain_members(by_id: dict, c: int) -> list:
    """All collective ids sharing c's chain (walk to the head, then down)."""
    preds = {s.next_coll: s.coll_id for s in by_id.values()
             if s.next_coll >= 0}
    head, hops = c, 0
    while head in preds:
        head = preds[head]
        hops += 1
        assert hops <= len(by_id), "cycle in collective chain"
    members = [head]
    while by_id[members[-1]].next_coll >= 0:
        members.append(by_id[members[-1]].next_coll)
        assert len(members) <= len(by_id), "cycle in collective chain"
    return members


def _build_stage_maps(t: StaticTables, c: int, s: CollectiveSpec,
                      slice_elems: int, inc: bool, outc: bool) -> None:
    """Precompute the padded-layout scatter/gather index maps of one
    collective (the registration-time analogue of NCCL's registered user
    buffers): logical element ``j`` of a chunked buffer lives at relative
    heap offset ``(j // chunk_log) * chunk_pad + j % chunk_log``; every
    offset of the padded span NOT covered by the map is a pad position
    the staging engine zero-fills on write (so stale heap data can never
    leak into the padded slices the daemon circulates).

    Two CollectiveSpec refinements generalize the maps for the a2a
    family without touching the staging engine (maps carry ALL layout
    logic downstream):

    * ``chunk_sizes`` (ALL_TO_ALL_RAGGED) — per-distance live element
      counts.  Chunk q keeps its full padded capacity on the heap/wire
      (the daemon's slicing is static), but only its first
      ``chunk_sizes[q]`` positions are mapped: the capacity-dropped rest
      are pads the engine zero-fills on write and never reads back, so
      both logical sizes become ``sum(chunk_sizes)``.
    * ``in_perm`` — a logical-input permutation composed into the INPUT
      map only: caller-logical element j stages to the heap position of
      stage-local element ``in_perm[j]``.  Composite a2a plans use it to
      fold the inter-stage granule transpose into the existing chain
      relink (which composes stage_out_map[pred] with stage_in_map[succ]
      over logical j, so a permuted successor input IS the transpose).
    """
    cp = s.n_rounds * s.n_slices * slice_elems        # padded chunk extent
    cl = -(-s.n_elems // s.group_size)                # ceil: logical chunk
    in_log = s.n_elems if inc else cl
    out_log = s.n_elems if outc else cl
    in_span = (s.group_size if inc else 1) * cp
    out_span = (s.group_size if outc else 1) * cp

    def chunked_map(n_logical: int) -> np.ndarray:
        j = np.arange(n_logical, dtype=np.int32)
        return (j // cl) * cp + (j % cl)

    if s.chunk_sizes:
        assert inc and outc, "ragged sizes require a both-sides-chunked kind"
        sizes = np.asarray(s.chunk_sizes, np.int64)
        assert len(sizes) == s.group_size and (sizes >= 0).all() and (
            sizes <= cl).all(), (
            f"collective {c}: chunk_sizes must be {s.group_size} counts "
            f"in [0, {cl}], got {s.chunk_sizes}")
        ragged = np.concatenate([
            q * cp + np.arange(sizes[q], dtype=np.int32)
            for q in range(s.group_size)]).astype(np.int32)
        in_log = out_log = int(sizes.sum())
        in_map = out_map = ragged
    else:
        in_map = (chunked_map(in_log) if inc
                  else np.arange(in_log, dtype=np.int32))
        out_map = (chunked_map(out_log) if outc
                   else np.arange(out_log, dtype=np.int32))

    if s.in_perm:
        perm = np.asarray(s.in_perm, np.int64)
        assert perm.shape == (in_log,) and np.array_equal(
            np.sort(perm), np.arange(in_log)), (
            f"collective {c}: in_perm must be a permutation of "
            f"range({in_log})")
        in_map = in_map[perm]

    t.chunk_pad[c] = cp
    t.chunk_log[c] = cl
    t.in_log[c] = in_log
    t.out_log[c] = out_log
    t.in_span[c] = in_span
    t.out_span[c] = out_span
    t.stage_in_map[c] = in_map.astype(np.int32)
    t.stage_out_map[c] = out_map.astype(np.int32)
