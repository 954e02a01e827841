"""Hang -> diagnose -> evict -> resume: the reliability loop end to end.

An 8-rank grad-sync round wedges because rank 5 dies mid-step.  The
drive times out with a :class:`DeadlockTimeout` that carries the flight
recorder's export and a diagnosis naming the holder; ``evict(5)`` drains
the fabric, rebuilds every communicator and registration for 7 ranks,
replays the survivors' staged submissions and finishes the round in ONE
relaunch -- bit-identical to a fresh 7-rank runtime driving the same
workload, which this script verifies at the end.  Port of
``examples/elastic_shrink.py``.

    python -m repro_torch.examples.elastic_shrink [--device cpu]
"""
from __future__ import annotations

import numpy as np

from ..core import (EVENT_NAMES, CollKind, DeadlockTimeout, OcclConfig,
                    OcclRuntime, events)
from ..core.state import resolve_device
from . import arg_parser, fabric_totals

R, C, N = 8, 4, 1024
DEAD = 5


def build(n_ranks: int, device):
    cfg = OcclConfig(n_ranks=n_ranks, max_colls=C + 2, max_comms=1,
                     slice_elems=64, conn_depth=8, heap_elems=1 << 16,
                     superstep_budget=1 << 15)
    rt = OcclRuntime(cfg, device=device)
    comm = rt.communicator(range(n_ranks))
    # register() returns CollectiveHandles: they survive the shrink by
    # re-resolving through the registration log, so the SAME handle
    # objects keep working after evict() rebuilds the id space.
    handles = [rt.register(CollKind.ALL_REDUCE, comm, n_elems=N)
               for _ in range(C)]
    return rt, handles


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    # Integer-valued payloads make the ring reduction exact, so the final
    # comparison against the fresh 7-rank runtime can demand bit-equality.
    rng = np.random.RandomState(0)
    payload = {(r, c): rng.randint(0, 1 << 10, N).astype(np.float32)
               for r in range(R) for c in range(C)}

    rt, hs = build(R, device)

    # --- 1. the wedged round: rank 5 dies, everyone else submits --------
    for c, h in enumerate(hs):
        for r in range(R):
            if r != DEAD:
                h.submit(r, prio=c, data=payload[(r, c)])
    try:
        rt.drive(max_launches=4)
        raise SystemExit("expected a DeadlockTimeout")
    except DeadlockTimeout as e:
        print("drive() timed out, as expected:")
        print(f"  {e}\n")
        # The exception carries the flight recorder's export: the newest
        # per-collective events of the wedged rank's peers show the fabric
        # stalled waiting, not computing.
        tail = ", ".join(f"{EVENT_NAMES[ev.kind]}(coll={ev.coll})"
                         for ev in events(e.flight_record, rank=0)[-3:])
        print("  rank 0 recorder tail:", tail)
        assert DEAD in e.diagnosis.holders
        res = {"timeout": str(e), "holders": list(e.diagnosis.holders),
               "tail": tail}
    hang = rt.stats()

    # --- 2. evict the dead rank and resume ------------------------------
    report = rt.evict(DEAD)
    print(f"\nevict({DEAD}): now R={report['n_ranks']}, replayed "
          f"{report['replayed']} staged submissions, dropped "
          f"{report['dropped']} from the dead rank "
          f"(generation {report['generation']})")
    shrunk = rt.stats()
    steps = int(shrunk["supersteps"].max())
    print(f"survivors' round completed in {steps} supersteps after rebuild")

    # --- 3. verify bit-equality against a fresh 7-rank runtime ----------
    survivors = [r for r in range(R) if r != DEAD]
    fresh, fhs = build(R - 1, device)
    for c, h in enumerate(fhs):
        for new_r, old in enumerate(survivors):
            h.submit(new_r, prio=c, data=payload[(old, c)])
    fresh.drive()
    for c in range(C):
        for new_r in range(R - 1):
            np.testing.assert_array_equal(np.asarray(hs[c].read(new_r)),
                                          np.asarray(fhs[c].read(new_r)))
    fst = fresh.stats()
    fresh_steps = int(fst["supersteps"].max())
    print(f"\nOK — bit-identical to a fresh {R - 1}-rank runtime "
          f"({steps} vs {fresh_steps} supersteps).")
    res.update(evict={k: report[k] for k in ("n_ranks", "replayed",
                                             "dropped", "generation")},
               supersteps=steps, fresh_supersteps=fresh_steps,
               fabric=fabric_totals(hang, shrunk, fst))
    return res


if __name__ == "__main__":
    main()
