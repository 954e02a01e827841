"""Tiny versions of the benchmark's configurations and cells, for CPU
tests: the same files cut by their family's ``tiny`` so that a cell's whole
run takes seconds on the CPU.  Every configuration and cell of
``BENCHMARK.json`` is here, found by file."""
from __future__ import annotations

import copy
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from occl_bench.harness import manifest  # noqa: E402

MAN = manifest.load()
# The manifest's cells, then any workload file it does not list (a cell
# kept for later: its driver stays under test).
CELLS = tuple(w["name"] for w in MAN["workloads"])
CELLS += tuple(sorted(p.stem for p in (BENCH / "workloads").glob("*.json")
                      if p.stem not in CELLS))
CONFIGS = tuple(c["name"] for c in MAN["configs"])


def _load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def family_of(name: str):
    """The family module of configuration ``name``."""
    return manifest.family(_load(f"configs/{name}.json")["family"])


def tiny(cfg_name: str, wl: dict | None = None) -> tuple[dict, dict]:
    cfg = copy.deepcopy(_load(f"configs/{cfg_name}.json"))
    return family_of(cfg_name).tiny(cfg, copy.deepcopy(wl or {}))


def config(name: str) -> dict:
    return tiny(name)[0]


def workload(name: str) -> dict:
    wl = _load(f"workloads/{name}.json")
    return tiny(wl["config"], wl)[1]


def training(cell: str) -> bool:
    """Whether the cell's family trains (its reference follows steps)."""
    return hasattr(family_of(workload(cell)["config"]), "CHECKED_STEPS")


def first_cells() -> list:
    """One cell of each configuration: the first the manifest lists."""
    out = {}
    for w in MAN["workloads"]:
        out.setdefault(w["config"], w["name"])
    return list(out.values())


def run(name: str, seed: int = 7, seconds: float = 0.0, trace=False,
        metrics=()):
    """The cell's whole run on the CPU (no look for a card)."""
    import time

    import torch
    from occl_bench.harness import cell

    torch.set_num_threads(1)
    wl = workload(name)
    return cell.run(config(wl["config"]), wl, seed, seconds, "cpu",
                    time.perf_counter(), metrics, trace,
                    log=lambda msg: None)
