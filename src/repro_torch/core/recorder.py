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
:func:`export_record` and :func:`events`.  The host-side hang diagnosis
(``diagnose``) is not ported yet (ROADMAP.md, "Modules to port", item 6).
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
