"""The superstep sweep's configurations and workloads, with no JAX import:
``test_torch_superstep.py`` builds them on the reference, and the card
tests of ``test_torch_superstep_kernel.py`` build them on the port.

The sweep covers burst widths 1 and 4, the flight recorder on and off (and
a ring shorter than one superstep's events), FIFO and PRIORITY with
preemption and aging, the stickiness / demand-steering / stall-weight
ablations, every reduce op and a bfloat16 heap; ``chain`` is a composite
two-level all-reduce (device-chained stages) beside a flat all-gather.
"""
import numpy as np

CONFIGS = {
    "b1_fr": dict(burst_slices=1, flight_recorder=True),
    "b4_nofr": dict(burst_slices=4, flight_recorder=False),
    "b4_prio": dict(burst_slices=4, order_policy="PRIORITY",
                    priority_preempts=True, prio_aging_quantum=3,
                    prio_aging_cap=5),
    "b1_ablate": dict(burst_slices=1, stickiness=False,
                      demand_steering=False, queue_conditional_stall=False,
                      recorder_len=3),
    "b4_bf16": dict(burst_slices=4, dtype="bfloat16",
                    queue_conditional_stall=False),
}
CAPTURE = (0, 3, 7, 12, 18, 25, 33, 42)
R = 4


def workload_kw(core, cfg_kw) -> dict:
    """The configuration of the six-collective workload (an order policy
    named in ``cfg_kw`` resolved in ``core``)."""
    kw = dict(n_ranks=R, max_colls=6, max_comms=2, slice_elems=4,
              conn_depth=5, heap_elems=1 << 12, cq_len=8,
              superstep_budget=1 << 12)
    kw.update(cfg_kw)
    if isinstance(kw.get("order_policy"), str):
        kw["order_policy"] = core.OrderPolicy[kw["order_policy"]]
    return kw


def build_workload(core, cfg_kw, **rt_kw):
    """Six collectives on two lanes, submitted in seeded per-rank orders
    (priorities random), flushed and packed, on the runtime of ``core``
    (``repro.core`` or ``repro_torch.core``).  Returns (cfg, kw, rt)."""
    kw = workload_kw(core, cfg_kw)
    cfg = core.OcclConfig(**kw)
    rt = core.OcclRuntime(cfg, **rt_kw)
    a = rt.communicator(range(R))
    b = rt.communicator(range(1, R))
    K, op = core.CollKind, core.ReduceOp
    regs = [(K.ALL_REDUCE, a, 40, op.SUM, 0),
            (K.ALL_GATHER, a, 24, op.SUM, 0),
            (K.BROADCAST, a, 30, op.SUM, 1),
            (K.REDUCE_SCATTER, b, 33, op.MIN, 0),
            (K.REDUCE, b, 21, op.PROD, 2),
            (K.ALL_REDUCE, b, 17, op.MAX, 0)]
    ids = [rt.register(k, c, n, op=o, root=root)
           for k, c, n, o, root in regs]
    rng = np.random.RandomState(5)
    for r in range(R):
        for i in rng.permutation(len(ids)):
            spec = rt.specs[ids[i]]
            if r not in spec.comm.members:
                continue
            rt._ensure_built()
            n = int(rt._tables.in_log[ids[i]])
            rt.submit(r, ids[i], prio=int(rng.randint(-3, 4)),
                      data=rng.randn(n).astype(np.float32))
    rt._flush_staged()
    return cfg, kw, rt


def build_chain_workload(core, **rt_kw):
    """A composite two-level all-reduce (a device-chained stage sequence on
    derived lanes) beside a flat all-gather.  Returns (cfg, kw, rt)."""
    kw = dict(n_ranks=R, max_colls=6, max_comms=3, slice_elems=4,
              conn_depth=5, heap_elems=1 << 12, cq_len=8, burst_slices=2,
              superstep_budget=1 << 12)
    cfg = core.OcclConfig(**kw)
    rt = core.OcclRuntime(cfg, **rt_kw)
    two = rt.register(core.CollKind.ALL_REDUCE,
                      rt.logical_communicator(range(R)), 40,
                      algo="two_level", hierarchy=(2, 2))
    flat = rt.register(core.CollKind.ALL_GATHER, rt.communicator(range(R)),
                       24)
    rt._ensure_built()
    rng = np.random.RandomState(9)
    for r in range(R):
        for c in ([two, flat] if r % 2 else [flat, two]):
            n = int(rt._tables.in_log[c])
            rt.submit(r, c, data=rng.randn(n).astype(np.float32))
    rt._flush_staged()
    return cfg, kw, rt
