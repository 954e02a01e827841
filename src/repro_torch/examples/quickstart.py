"""Quickstart: the OCCL public API in 40 lines.

Register a communicator + collectives ONCE, then submit from any rank in
ANY order -- no cross-rank ordering discipline needed.  Completion arrives
via callbacks (the CQ poller), exactly the integration contract of paper
Sec. 4.  Port of ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np

from ..core import CollKind, OcclConfig, OcclRuntime
from ..core.state import resolve_device
from . import arg_parser, fabric_totals

R = 4


def main(argv=None) -> dict:
    args = arg_parser(__doc__).parse_args(argv)
    device = resolve_device(args.device)
    cfg = OcclConfig(n_ranks=R, max_colls=4, max_comms=1,
                     slice_elems=64, conn_depth=4, heap_elems=1 << 14)
    rt = OcclRuntime(cfg, device=device)
    world = rt.communicator(list(range(R)))

    grads = rt.register(CollKind.ALL_REDUCE, world, n_elems=1024)
    acts = rt.register(CollKind.ALL_GATHER, world, n_elems=512)

    rng = np.random.RandomState(0)
    g = [rng.randn(1024).astype(np.float32) for _ in range(R)]
    a = [rng.randn(128).astype(np.float32) for _ in range(R)]

    done = []
    for r in range(R):
        # each rank picks its own order -- rank parity inverts it (this
        # would deadlock a single-FIFO-queue library, Fig. 1a)
        order = [(grads, g[r]), (acts, a[r])]
        if r % 2:
            order.reverse()
        for cid, data in order:
            rt.submit(r, cid, data=data,
                      callback=lambda rank, c: done.append((rank, c)))

    rt.drive()   # event-driven daemon launches until every CQE has landed

    np.testing.assert_allclose(rt.read_output(0, grads), sum(g), rtol=1e-5)
    np.testing.assert_allclose(rt.read_output(3, acts),
                               np.concatenate(a), rtol=1e-5)
    st = rt.stats()
    res = {"completed": len(done), "n_ranks": R,
           "supersteps": int(st["supersteps"].max()),
           "preempts": int(st["preempts"].sum()),
           "fabric": fabric_totals(st)}
    print(f"completed {res['completed']} collective executions on {R} ranks "
          f"in {res['supersteps']} supersteps "
          f"({res['preempts']} preemptions; orders were adversarial)")
    print("OK")
    return res


if __name__ == "__main__":
    main()
