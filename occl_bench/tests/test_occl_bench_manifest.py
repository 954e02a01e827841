"""BENCHMARK.json against its contract and against the files it names:
names, units, keys, each configuration's cell, each metric's reader and
the cells that report it."""
import json
import re

import pytest

import occl_bench_tiny as tiny  # src/ and the root on sys.path
from occl_bench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(_size$|_dim$|_rank$|intermediate|expan|"
                   r"experts_per_tok)")
# What `reduced` may cut: depth, and the chip's share of experts or of the
# vocabulary.  A departure of the program from the published model is no cut.
CUTS = {"num_hidden_layers", "n_routed_experts", "num_local_experts",
        "vocab_size"}

MAN = manifest.load()
# Every reader file: the manifest's metrics, and any kept for a later cell.
READERS = tuple(sorted(p.stem for p in (manifest.BENCH / "metrics")
                       .glob("*.py")))


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(MAN) == TOP
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(MAN["command"]) <= 32
    assert all(line(w) for w in MAN["command"])
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names), names


def test_metric_names_units_and_keys():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} == {"step_s", "setup_s"}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_per_layer_metric_moves_step_s_in_cells_that_report_it():
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] == "step_s"
        assert set(m["workloads"]) <= cells
    for w in cells:
        assert manifest.metrics_for(MAN, w), w


def test_every_manifest_metric_has_its_reader_file():
    assert {m["name"] for m in MAN["per_layer"]} <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_metric_file_matches_the_manifest(metric):
    # the manifest alone gives the metric's layer, unit and cells
    assert callable(manifest.reader(metric).read)


def test_metrics_of_one_layer_name_it_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("cfg", [c["name"] for c in MAN["configs"]])
def test_each_configuration_has_a_cell_and_its_file(cfg):
    entry = next(c for c in MAN["configs"] if c["name"] == cfg)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    assert any(w["config"] == cfg for w in MAN["workloads"])
    body = manifest.config(MAN, cfg)
    assert body["name"] == cfg and body["source"] == entry["source"]
    assert body["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert key in body["published"], key
        assert body[key] != body["published"][key], key
        assert not WIDTH.search(key), key
        assert key in CUTS, key
    for key, value in body["published"].items():
        assert key in entry["reduced"] or body[key] == value, key
    # a departure is stated beside the published value, never as a
    # top-level key that `reduced` would have to list
    for key, d in body.get("departures", {}).items():
        assert key not in body, key
        if isinstance(d, dict):
            assert set(d) == {"published", "run"}, key
            assert d["published"] != d["run"], key
    assert line(entry["why"]) and line(entry["source"])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_cell_file_matches_the_manifest(cell):
    wl = manifest.workload(cell)
    # a workload file the manifest does not list is a cell kept for later:
    # its own entry has to be one the manifest could take as it stands
    entry = next((w for w in MAN["workloads"] if w["name"] == cell),
                 {k: wl[k] for k in ("name", "config", "traffic", "chips",
                                     "why")})
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["config"] in {c["name"] for c in MAN["configs"]}
    for k in ("name", "config", "traffic", "chips", "why"):
        assert wl[k] == entry[k], k
    assert entry["chips"] in (1, 4)
    assert line(entry["why"])
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(pairs) // 4)


def test_files_under_paths_are_named_from_name_characters():
    root = manifest.BENCH
    for p in root.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(manifest.ROOT).as_posix()
            assert PATH.match(rel), rel
    json.dumps(MAN)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_files_a_cell_names_are_found_by_name(cell):
    wl = manifest.workload(cell)
    cfg = manifest.config(MAN, wl["config"])
    assert callable(manifest.driver(wl["driver"]).run)
    fam = manifest.family(cfg["family"])
    for name in ("params", "step_flops", "standin", "tiny"):
        assert callable(getattr(fam, name)), name
    assert "control" in fam.KINDS
    ref = manifest.reference(cfg["reference"])
    assert callable(ref.param_shapes)


def test_a_name_that_is_no_module_is_refused():
    with pytest.raises(SystemExit):
        manifest.driver("../harness/cell")
