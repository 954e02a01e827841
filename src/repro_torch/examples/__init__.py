"""The reference's eight examples as the port's entry points.

Each module is the port of ``examples/<name>.py`` under the same name, run
as ``python -m repro_torch.examples.<name>`` (on the card; ``--device
cpu`` for the plain PyTorch path):

* :mod:`.quickstart` -- the public API: register once, submit in any order;
* :mod:`.adversarial_orders` -- a workload that deadlocks a single-FIFO
  library completes under OCCL (paper Sec. 5.2);
* :mod:`.elastic_shrink` -- hang, diagnose, evict, resume;
* :mod:`.hierarchical_allreduce` -- two-level chains, ``auto``, chained
  orders;
* :mod:`.moe_alltoall` -- the relay-ring and two-level all-to-all,
  expert-parallel MoE dispatch;
* :mod:`.overlap_training` -- grad sync and MoE exchanges inside the step;
* :mod:`.serve_batched` -- continuous batching and the QoS fabric;
* :mod:`.train_dp_occl` -- data-parallel training with OCCL grad sync,
  checkpoints and a recovery (paper Sec. 5.3).

Every module has ``main(argv=None) -> dict``: it prints the reference's
lines and returns their counts, with ``"fabric"``: the supersteps and
preempts of every OCCL runtime it drove.  Nothing runs at import.
"""
from __future__ import annotations

import argparse

__all__ = ["arg_parser", "fabric_totals"]


def arg_parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser: its docstring's first line and
    ``--device`` (default ``cuda``, which raises without a card)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def fabric_totals(*stats: dict) -> dict:
    """Totals over runtimes' ``stats()``: each one's superstep clock (the
    largest over its ranks) and its preempts, summed."""
    return {"supersteps": sum(int(s["supersteps"].max()) for s in stats),
            "preempts": sum(int(s["preempts"].sum()) for s in stats)}
