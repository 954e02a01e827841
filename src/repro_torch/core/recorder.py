"""Flight recorder: on-device event ring, exported and decoded on the host.

The scheduler appends one event per scheduling transition into a per-rank
fixed-size ring buffer living in :class:`~repro_torch.core.state.DaemonState`
(``fr_*`` fields), stamped with the cumulative epoch clock.  Event schema
(all int32):

====================  ============================================
kind                  meaning (``coll`` column / clock stamp)
====================  ============================================
``SUBMIT`` (0)        an SQE entered the task queue (entry stage id)
``STAGE_DONE`` (1)    a ring stage ran its last primitive (stage id)
``PREEMPT`` (2)       the lane rotated away from a spinning
                      collective (preempted stage id)
``CHAIN_HANDOFF`` (3) a completing stage enqueued its chain
                      successor on device (predecessor stage id)
``CQE`` (4)           a chain tail completed — host-visible CQE
                      (tail stage id)
====================  ============================================

Alongside the ring the state keeps wrap-proof per-kind cumulative
counters (``fr_kinds``) that reconcile with the scheduler's own counters.

PyTorch port of ``repro.core.recorder``: the constants, :class:`FlightEvent`,
:func:`export_record`, :func:`events` and the host side, :func:`diagnose`:
on a hang it names the rank + collective holding each stalled chain, first
from host submission bookkeeping (a member that never submitted, the
common lost-rank case), falling back to the recorder clock (the member
whose chain events are oldest).
"""
from __future__ import annotations

import dataclasses

# Event kinds (i32 values in ``fr_kind``).
EV_SUBMIT = 0
EV_STAGE_DONE = 1
EV_PREEMPT = 2
EV_CHAIN_HANDOFF = 3
EV_CQE = 4
N_EVENT_KINDS = 5
EVENT_NAMES = ("SUBMIT", "STAGE_DONE", "PREEMPT", "CHAIN_HANDOFF", "CQE")


@dataclasses.dataclass
class FlightEvent:
    """One decoded recorder entry (host-side view)."""

    rank: int
    kind: int
    coll: int
    step: int  # epoch-clock superstep stamp

    @property
    def kind_name(self) -> str:
        return EVENT_NAMES[self.kind] if 0 <= self.kind < N_EVENT_KINDS \
            else f"?{self.kind}"

    def __str__(self):
        return (f"[rank {self.rank} @ step {self.step}] "
                f"{self.kind_name} coll={self.coll}")


def export_record(state, cfg) -> dict:
    """Pull the recorder tensors off the device into a plain-numpy export.

    This is the payload ``stats()["flight_recorder"]`` returns and
    :class:`~repro_torch.core.errors.DeadlockTimeout` carries.
    """
    def host(t):
        return t.detach().cpu().numpy()

    return {
        "enabled": bool(cfg.flight_recorder),
        "recorder_len": int(cfg.recorder_len),
        "kind": host(state.fr_kind),      # [R, FR] i32 (-1 = empty)
        "coll": host(state.fr_coll),      # [R, FR] i32
        "step": host(state.fr_step),      # [R, FR] i32 epoch stamp
        "count": host(state.fr_count),    # [R] total events appended
        "kind_counts": host(state.fr_kinds),  # [R, N_EVENT_KINDS]
    }


def events(record: dict, rank: int | None = None) -> list[FlightEvent]:
    """Decode a record's ring into events, oldest -> newest per rank."""
    out: list[FlightEvent] = []
    fr = int(record["recorder_len"])
    ranks = range(record["kind"].shape[0]) if rank is None else (rank,)
    for r in ranks:
        n = int(record["count"][r])
        kept = min(n, fr)
        start = n - kept  # absolute index of oldest retained event
        for i in range(start, n):
            s = i % fr
            out.append(FlightEvent(rank=int(r),
                                   kind=int(record["kind"][r, s]),
                                   coll=int(record["coll"][r, s]),
                                   step=int(record["step"][r, s])))
    return out


# ----------------------------------------------------------------------
# Host-side hang diagnosis
# ----------------------------------------------------------------------
@dataclasses.dataclass
class StalledChain:
    """One logical collective that cannot complete, and who holds it."""

    coll_id: int          # logical (head) collective id
    algo: str
    members: tuple        # participating ranks
    waiting_ranks: list   # ranks with an outstanding submission
    holding_ranks: list   # ranks diagnosed as holding the chain
    reason: str

    def __str__(self):
        hold = ",".join(map(str, self.holding_ranks)) or "?"
        wait = ",".join(map(str, self.waiting_ranks))
        return (f"collective {self.coll_id} ({self.algo}) held by "
                f"rank(s) {hold}: {self.reason} "
                f"(waiting ranks: {wait})")


@dataclasses.dataclass
class Diagnosis:
    stalled: list

    @property
    def holders(self) -> list:
        """All ranks named as holding at least one stalled chain."""
        out: list[int] = []
        for s in self.stalled:
            for r in s.holding_ranks:
                if r not in out:
                    out.append(r)
        return sorted(out)

    def __str__(self):
        if not self.stalled:
            return "no stalled collectives (all submissions reconciled)"
        return "\n".join(str(s) for s in self.stalled)


def diagnose(runtime) -> Diagnosis:
    """Name the rank + collective holding each stalled chain.

    Two signals, in order of strength:

    1. Host submission bookkeeping: a member whose cumulative submit
       count for the collective lags the most-submitted member never
       handed the daemon its SQE — the lost-rank / withheld-submission
       case.  This is decisive because OCCL's preemption machinery makes
       *scheduling* deadlocks impossible; only a missing participant can
       wedge a chain.
    2. The flight recorder: if every member submitted equally, the
       member whose latest event touching the chain's stages is OLDEST
       on the epoch clock made the least recent progress.
    """
    stalled: list[StalledChain] = []
    by_coll: dict[int, list[int]] = {}
    for (r, cid), dq in runtime._outstanding.items():
        if dq:
            by_coll.setdefault(cid, []).append(r)
    record = runtime.export_flight_record()
    for cid in sorted(by_coll):
        waiting = sorted(by_coll[cid])
        members = tuple(runtime._logical_members.get(
            cid, runtime.specs[cid].comm.members))
        algo = runtime._algo_of.get(cid, "ring")
        counts = {m: runtime._submit_counts.get((m, cid), 0)
                  for m in members}
        mx = max(counts.values()) if counts else 0
        holders = [m for m in members if counts[m] < mx]
        if holders:
            reason = (f"never submitted (peers at {mx} submission"
                      f"{'s' if mx != 1 else ''})")
        else:
            # Everyone submitted: fall back to recorder recency over the
            # chain's stage ids.
            stages = set(runtime._chain_of.get(cid, [cid]))
            last: dict[int, int] = {}
            for ev in events(record):
                if ev.rank in counts and ev.coll in stages:
                    last[ev.rank] = max(last.get(ev.rank, -1), ev.step)
            oldest = min((last.get(m, -1) for m in members), default=-1)
            holders = [m for m in members if last.get(m, -1) == oldest]
            reason = (f"slowest chain progress (last recorded event at "
                      f"superstep {oldest})")
        stalled.append(StalledChain(coll_id=int(cid), algo=str(algo),
                                    members=members,
                                    waiting_ranks=waiting,
                                    holding_ranks=holders,
                                    reason=reason))
    return Diagnosis(stalled=stalled)
