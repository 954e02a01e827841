"""``BENCHMARK.json`` and the files it names: a configuration, a cell's
traffic and a per-layer metric are each a file of their own, found by the
name the manifest gives; a program path (``drivers/<driver>.py``), a model
family (``families/<family>.py``) and a plain reference
(``reference/<reference>.py``) are found by the name a workload or a
configuration file gives."""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return json.loads((BENCH / "workloads" / f"{name}.json").read_text())


def reported(man: dict, metric: dict, name: str) -> bool:
    """Whether cell ``name`` reports the per-layer ``metric``."""
    if "workloads" in metric:
        return name in metric["workloads"]
    e2e = next(m for m in man["end_to_end"] if m["name"] == metric["moves"])
    return "workloads" not in e2e or name in e2e["workloads"]


def reader(name: str):
    """The module ``metrics/<name>.py`` (its ``read(trace)``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"occl_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, name: str) -> list:
    return [m for m in man["per_layer"] if reported(man, m, name)]


def _module(kind: str, name: str):
    if not name.isidentifier():
        raise SystemExit(f"{kind}/{name}.py: not a module name")
    return importlib.import_module(f"{BENCH.name}.{kind}.{name}")


def driver(name: str):
    """``drivers/<name>.py``: ``run(ctx) -> Outcome``."""
    return _module("drivers", name)


def family(name: str):
    """``families/<name>.py``: weights, inputs, ``step_flops(cfg)``, the
    stand-ins (``KINDS``, ``standin``) and ``tiny(cfg, wl)``."""
    return _module("families", name)


def reference(name: str):
    """``reference/<name>.py``: the plain reference a configuration names."""
    return _module("reference", name)
