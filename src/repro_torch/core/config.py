"""Configuration for the OCCL deadlock-free collective runtime (PyTorch port).

The field set is the same as ``repro.core.config.OcclConfig``, so one
kwargs dict builds both configs, and the validation rejects the same
inputs.  All sizes are static per daemon instance, mirroring the paper's
registration-time preparation of collective contexts (Sec. 3.1.1).

Port notes: ``use_pallas`` is kept as a field for parity but has no effect
here — the port's scheduler always routes the fused-primitive slice math
through the kernel dispatcher (``repro_torch.kernels.ops``), which launches
the hand-written CUDA kernel for tensors on the card and uses its plain
PyTorch version for tensors on the CPU.  The mesh-backend knobs
(``packed_16bit``, ``cond_chain_relink``) and ``vectorized_inbox`` are kept
for the same reason; the sim-backend port has one inbox path, which is
value-identical to both of the reference's.

Launch-epoch clock invariants
-----------------------------
The daemon keeps TWO superstep clocks (state.py): a cumulative ``supersteps``
epoch counter that is never reset (observability / Fig. 9 stats) and a
per-launch ``launch_steps`` counter that the daemon prologue zeroes on every
(re)launch.  ``superstep_budget`` bounds ``launch_steps`` — it is a
*per-launch* bound, so the voluntary-quit/relaunch cycle (paper Sec. 3.1.3)
can repeat indefinitely without the budget ever going stale.

Task-queue order keys are built from the same launch clock: the scheduler
rebases every active collective's ``arrival`` to its queue rank (< max_colls)
in the launch prologue, and new fetches/rotations stamp
``max_colls + launch_steps``.  Queue age is therefore bounded by
``max_colls + superstep_budget + 2`` per launch, which MUST stay below
``QUEUE_KEY_DEMAND_STRIDE`` so the demand-steering bonus and the PRIORITY
class stride can never bleed into each other (validated in
``OcclConfig.__post_init__``).
"""
from __future__ import annotations

import dataclasses
import enum


# Queue-key class strides (scheduler._lane_keys).  Within one priority
# class the key is ``arrival - demand * QUEUE_KEY_DEMAND_STRIDE``; PRIORITY
# prepends ``-prio * QUEUE_KEY_PRIO_STRIDE``.  Keys are i32: with prio
# clipped to +/-512 (2^9) the extreme key magnitude is ~2^29 — no overflow —
# provided arrival stays below the demand stride (config validation below).
QUEUE_KEY_DEMAND_STRIDE = 1 << 18
QUEUE_KEY_PRIO_STRIDE = 1 << 20


class OrderPolicy(enum.IntEnum):
    """Order-adjusting policy of the stickiness scheme (paper Sec. 3.2)."""

    FIFO = 0      # empty the task queue ASAP; lazy SQ fetch; new at back
    PRIORITY = 1  # user priority first; eager SQ fetch; high-prio at front


class ReduceOp(enum.IntEnum):
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


@dataclasses.dataclass(frozen=True)
class OcclConfig:
    """Static configuration of one daemon instance.

    The daemon is compiled once per config (the analogue of launching the
    persistent daemon kernel with the max grid/block size, paper Sec. 4).
    """

    # --- geometry -------------------------------------------------------
    n_ranks: int = 8                # devices participating in the fabric
    max_colls: int = 16             # registered-collective slots (C)
    max_comms: int = 4              # communicator lanes (L); CUDA-block analogue
    slice_elems: int = 64           # elements per slice (preemption granule)
    conn_depth: int = 4             # ring-buffer slots per connector (K)
    burst_slices: int = 1           # max slices one lane moves per superstep
                                    # (B); the burst is credit-gated so the
                                    # deadlock-freedom capacity argument of
                                    # derive_slicing is unchanged, and a
                                    # collective stays preemptible between
                                    # bursts (slice granularity).  For
                                    # sustained B-slice throughput size
                                    # conn_depth >= ~3B (credit round trip;
                                    # see scheduler.py docstring)
    auto_conn_depth: bool = False   # derive conn_depth =
                                    # max(conn_depth, 3 * burst_slices) at
                                    # construction so bursts never fall into
                                    # the 1-slice/superstep credit-return
                                    # equilibrium.  Off by default: resizing
                                    # the connector changes derive_slicing
                                    # (rounds/slices), so it must be an
                                    # explicit choice; when off, the runtime
                                    # warns at registration time instead.
    heap_elems: int = 1 << 16       # per-rank data heap (send/recv buffers)

    # --- SQ / CQ --------------------------------------------------------
    sq_len: int = 64                # submission-queue slots per rank
    cq_len: int = 64                # completion-queue slots per rank

    # --- scheduling / stickiness (paper Sec. 3.2) -----------------------
    order_policy: OrderPolicy = OrderPolicy.FIFO
    stickiness: bool = True         # master switch (Fig. 9 ablation)
    priority_preempts: bool = False  # P3/PACE-style: a strictly-higher-
                                    # priority queued collective preempts the
                                    # current one (paper Sec. 3.2 / Sec. 6:
                                    # a spin-threshold adjusting policy)
    demand_steering: bool = True    # beyond-paper gang policy: prefer
                                    # collectives whose recv connector has
                                    # data waiting (local evidence that ring
                                    # peers are executing them) — same
                                    # decentralized-information constraint
                                    # as the paper's spin-threshold scheme
                                    # but converges faster under adversarial
                                    # order skew (benchmarks/bench_gang.py)
    # Spin thresholds/counts are in units of STALLED SLICES, not stalled
    # supersteps: a lane denied its whole burst advances ``spin`` by up to
    # ``burst_slices`` per superstep (scheduler.lanes_step), so at B > 1 a
    # stalled collective yields its lane in proportionally fewer wall
    # supersteps and the freed supersteps go to collectives with queued
    # demand.  At B = 1 a stalled superstep denies exactly one slice, so
    # the accounting is bit-identical to the seed superstep-counting spin.
    queue_conditional_stall: bool = True  # weight stall units by lane queue
                                    # length: a lane with NO other eligible
                                    # collective queued (solo) advances spin
                                    # by 1 per stalled superstep (preempting
                                    # it frees nothing, so B×-eager rotation
                                    # during the credit round trip is pure
                                    # churn), while contended lanes keep the
                                    # fast B-scaled denied-slice accounting.
                                    # False restores unconditional B-scaling
                                    # (the PR-2 behavior; ablation switch).
                                    # At B = 1 both settings are identical.
    spin_base: int = 16             # initial threshold of queue-front coll
    spin_decr: int = 4              # threshold decrement per queue position
    spin_boost: int = 8             # boost to successors on primitive success
    spin_min: int = 1
    spin_max: int = 256
    # Priority aging (QoS starvation bound, serving/qos.py): under
    # OrderPolicy.PRIORITY a queued collective's EFFECTIVE priority is
    # ``prio + min(queue_age // prio_aging_quantum, prio_aging_cap)``,
    # used for BOTH the queue-order key and the priority_preempts
    # comparison and clipped to the same +/-512 band as user priority —
    # the queue-key magnitude proof above is unchanged.  Queue age is
    # measured on the per-launch clock (``max_colls + launch_steps -
    # arrival``), so rebase_arrivals resets it at every relaunch: a bump
    # never outlives the launch that earned it.  0 disables aging and is
    # bit-identical to the pre-knob scheduler.
    prio_aging_quantum: int = 0     # queue-age supersteps per +1 eff. prio
    prio_aging_cap: int = 127       # max aging bump; conservative default
                                    # stays UNDER one serving class stride
                                    # (128) — aged work reorders within its
                                    # class only.  serving/qos.py passes 255
                                    # to allow exactly one class crossing.

    # --- daemon lifecycle (paper Sec. 3.1.3) ----------------------------
    quit_threshold: int = 64        # voluntary quit after this many
                                    # no-progress supersteps
    superstep_budget: int = 4096    # hard bound on launch_steps PER daemon
                                    # launch (reset in the launch prologue;
                                    # the cumulative epoch clock is separate
                                    # and unbounded)

    # --- collective algorithms (composite layer, core/algos.py) ---------
    algo: str = "ring"              # default algorithm for register():
                                    # "ring" (flat single-communicator);
                                    # the composite plans "two_level",
                                    # "torus", "hybrid" (ALL_REDUCE) and
                                    # "tree" (BROADCAST/REDUCE) over a
                                    # G x N rank grid; or "auto" — rank the
                                    # registered candidate plans with the
                                    # measured α-β-γ cost model
                                    # (core/costmodel.py, calibrated by
                                    # benchmarks/calibrate.py into
                                    # BENCH_calibration.json).
                                    # register(algo=...) overrides per
                                    # collective.

    # --- lane bandwidth skew (sim backend physical model) ---------------
    # Model a hierarchical fabric: the n_ranks are split into
    # ``bandwidth_groups`` equal islands of consecutive ranks (NVLink
    # boxes / hosts); a lane whose ring permutation has ANY hop crossing
    # an island boundary is an INTER lane, the rest are INTRA lanes.  A
    # lane moves at most its class cap slices per superstep (0 = the full
    # burst_slices; caps clamp to [1, burst_slices]).  bandwidth_groups=0
    # disables the model — every lane keeps the uniform burst, and the
    # scheduler math is value-identical to the unskewed path.  This is
    # what lets the sim backend measure WALL-CLOCK algorithm crossovers
    # (flat rings cross islands every ~N hops; hierarchical plans confine
    # the bulk to intra lanes), feeding the algos bench section and the
    # cost-model calibration.
    bandwidth_groups: int = 0
    intra_burst_cap: int = 0        # islands-local lanes (0 = burst_slices)
    inter_burst_cap: int = 0        # island-crossing lanes (0 = burst_slices)

    # --- flight recorder (fleet observability, core/recorder.py) --------
    flight_recorder: bool = True    # record per-collective scheduling
                                    # events (SUBMIT fetch, STAGE_DONE,
                                    # PREEMPT, CHAIN_HANDOFF, CQE) into a
                                    # per-rank on-device ring buffer
                                    # stamped with the epoch clock.
                                    # Exported by ``stats()
                                    # ["flight_recorder"]`` and attached
                                    # to DeadlockTimeout; False removes
                                    # every recorder op from the compiled
                                    # superstep (bit-identical schedule).
    recorder_len: int = 128         # ring-buffer slots per rank; the
                                    # per-kind cumulative counters are
                                    # wrap-proof, only the event ring
                                    # itself keeps the newest
                                    # ``recorder_len`` events.  A single
                                    # superstep can emit up to
                                    # 4*max_comms + 1 events (4 transition
                                    # kinds per lane + 1 SQE fetch);
                                    # smaller rings stay deterministic
                                    # (the scheduler pre-drops the oldest
                                    # events of an over-long batch), but
                                    # recorder_len >= 4*max_comms + 1
                                    # guarantees the decoded ring is a
                                    # gap-free suffix of the event stream

    # --- numerics / kernels ---------------------------------------------
    dtype: str = "float32"          # heap / wire dtype
    use_pallas: bool = False        # reference: route slice math through
                                    # Pallas kernels; port: no effect (the
                                    # kernel dispatcher is always used)

    # --- mesh-backend fast path -----------------------------------------
    packed_16bit: bool = True       # mesh backend: bitcast PAIRS of 16-bit
                                    # payload elements into i32 lanes so
                                    # bf16/f16 heaps ride the same single
                                    # fused header++payload forward ppermute
                                    # as 32-bit dtypes (2 ppermutes per
                                    # superstep instead of 3; an odd lane is
                                    # zero-padded and sliced off on receive).
                                    # False restores the separate
                                    # header/payload ppermute pair (escape
                                    # hatch; bit-identical results).
    cond_chain_relink: bool = True  # mesh backend: wrap the chain-relink
                                    # gather/scatter in a lax.cond on "any
                                    # chained stage completed this
                                    # superstep", so workloads that
                                    # registered chains but complete none
                                    # in a given superstep skip the relink
                                    # memory traffic (it fires on the rare
                                    # completion supersteps only).  Sim
                                    # backend ignores it: under vmap a
                                    # lax.cond degenerates to a select and
                                    # both branches execute anyway.  False
                                    # restores the unconditional scatter
                                    # (escape hatch; bit-identical results).
    vectorized_inbox: bool = True   # apply_inbox: flatten the (coll, slot)
                                    # scatter grid through a precomputed
                                    # [L, B] burst-offset table into ONE
                                    # single-axis scatter over the
                                    # [C*K, SLICE] payload view.  False
                                    # restores the two-axis scatter (escape
                                    # hatch; bit-identical results).

    def __post_init__(self):
        assert self.n_ranks >= 1
        assert self.max_comms >= 1
        assert self.conn_depth >= 1
        assert self.slice_elems >= 1
        assert self.burst_slices >= 1
        assert self.spin_base >= self.spin_min
        assert self.algo in ("ring", "two_level", "torus", "hybrid",
                             "tree", "auto"), self.algo
        assert self.recorder_len >= 1
        assert self.prio_aging_quantum >= 0
        assert 0 <= self.prio_aging_cap <= 511, (
            "prio_aging_cap must stay within the +/-512 priority clip "
            "band (queue-key magnitude proof)")
        assert self.bandwidth_groups >= 0
        assert self.intra_burst_cap >= 0 and self.inter_burst_cap >= 0
        if self.bandwidth_groups > 1:
            assert self.n_ranks % self.bandwidth_groups == 0, (
                f"bandwidth_groups={self.bandwidth_groups} must divide "
                f"n_ranks={self.n_ranks} (equal islands)")
        if self.auto_conn_depth and self.conn_depth < 3 * self.burst_slices:
            # Credit round trip (commit, consume, credit-return) is ~3
            # supersteps; K >= 3B keeps the ring from saturating.
            object.__setattr__(self, "conn_depth", 3 * self.burst_slices)
        # Queue-key class separation (see module docstring): the largest
        # per-launch arrival value must stay below the demand stride.
        assert (self.superstep_budget + self.max_colls + 2
                < QUEUE_KEY_DEMAND_STRIDE), (
            "superstep_budget too large for i32 queue keys: need "
            f"superstep_budget + max_colls + 2 < {QUEUE_KEY_DEMAND_STRIDE} "
            "(split work across launches — the budget is per launch)")
