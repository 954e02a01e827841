"""A new family is new files: in a copy of the benchmark, a throwaway
family, driver, reference, configuration, cell and reader are added as
files (and as entries of the copy's ``BENCHMARK.json``), no file that was
there is edited, and the manifest, the run of a cell, the stand-ins,
``calibrate.py`` and the FLOP count all find them."""
import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

import occl_bench_tiny as tiny

CELL = "toy-allreduce.sum"

FILES = {
    "configs/toy-allreduce.json": {
        "name": "toy-allreduce", "source": "https://example.org/toy",
        "family": "toy", "reference": "toy_sum", "published": {},
        "reduced": [], "n_elems": 256,
        "precision": {"params": "float32", "compute": "float32",
                      "peak": "fp32", "control": "fp16"},
        "deployment": {"ranks": 2, "slice_elems": 64}},
    "workloads/toy-allreduce.sum.json": {
        "name": CELL, "config": "toy-allreduce", "traffic": "sum",
        "chips": 1, "why": "a throwaway all-reduce", "driver": "toy_allreduce",
        "limits": {"out_gap": 1e-6}},
    "reference/toy_sum.py": '''
        """The sum over ranks, in float64."""
        import torch


        def param_shapes(cfg):
            return {}


        def total(xs, dtype=torch.float64):
            return sum(x.to(dtype) for x in xs)
        ''',
    "families/toy.py": '''
        """A throwaway all-reduce family."""
        import torch

        from ..harness.feed import generator

        KINDS = ("control",)


        def params(cfg, seed, device, ref):
            return {}


        def inputs(cfg, seed, step, device):
            g = generator(device, seed, "toy", step)
            return [torch.randn(cfg["n_elems"], generator=g, device=device)
                    for _ in range(cfg["deployment"]["ranks"])]


        def step_flops(cfg):
            return cfg["n_elems"] * (cfg["deployment"]["ranks"] - 1)


        def gap(got, want):
            return float((got.double() - want).abs().max()
                         / want.abs().max())


        def standin(cfg, wl, seed, device, kind, ref):
            xs = inputs(cfg, seed, 0, device)
            return {"out_gap": gap(ref.total(xs, torch.float16),
                                   ref.total(xs))}


        def tiny(cfg, wl):
            return cfg, wl
        ''',
    "drivers/toy_allreduce.py": '''
        """The throwaway family's path: one all-reduce a step, staged."""
        import torch

        from ..harness.window import Outcome


        def run(ctx):
            from repro_torch.core import CollKind, OcclConfig, OcclRuntime

            cfg, fam, ref = ctx.cfg, ctx.family, ctx.reference
            R = cfg["deployment"]["ranks"]
            rt = OcclRuntime(OcclConfig(
                n_ranks=R, max_colls=2, max_comms=1, conn_depth=4,
                slice_elems=cfg["deployment"]["slice_elems"],
                heap_elems=1 << 12), device=ctx.device)
            cid = rt.register(CollKind.ALL_REDUCE,
                              rt.communicator(list(range(R))),
                              n_elems=cfg["n_elems"])
            outs = []
            ctx.window.start(rt)
            while True:
                xs = fam.inputs(cfg, ctx.seed, len(outs), ctx.device)
                for r, x in enumerate(xs):
                    rt.submit(r, cid, data=x.numpy())
                rt.drive()
                outs.append(torch.from_numpy(rt.read_output(0, cid)))
                if ctx.window.step_done():
                    break

            def check():
                return {"out_gap": max(
                    fam.gap(got, ref.total(fam.inputs(cfg, ctx.seed, s,
                                                      ctx.device)))
                    for s, got in enumerate(outs))}
            return Outcome(check, lambda: None)
        ''',
    "metrics/toy_program_spans.py": '''
        """The program tracer's spans and the staging bytes of the window."""
        PROGRAM_TRACE = True


        def read(t):
            if t["program"] is None:
                return None
            return (len(t["program"]["spans"]),
                    t["counters"]["staging_flush_bytes"])
        ''',
}

SCRIPT = '''
import json, sys, time
from occl_bench import calibrate
from occl_bench.harness import cell, manifest, standins
from occl_bench.roofline import flops

man = manifest.load()
entry = manifest.cell(man, "%(cell)s")
wl = manifest.workload("%(cell)s")
cfg = manifest.config(man, entry["config"])
res = cell.run(cfg, wl, 2 ** 31 + 11, 0.0, "cpu", time.perf_counter(),
               manifest.metrics_for(man, "%(cell)s"), True,
               log=lambda m: None)
control = standins.read(cfg, wl, 3, "cpu", "control")
rc = calibrate.main(["--workload", "%(cell)s", "--seeds", "5",
                     "--stand-in-seeds", "6", "--device", "cpu"])
print(json.dumps({"correct": res["correct"], "checks": res["checks"],
                  "metrics": res["metrics"], "kinds": standins.kinds(cfg),
                  "control": control, "calibrate": rc,
                  "flops": flops.step_flops(cfg),
                  "driver": manifest.driver(wl["driver"]).__file__}))
'''


def digest(root) -> dict:
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_is_new_files(tmp_path):
    bench = tmp_path / "occl_bench"
    shutil.copytree(tiny.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    for rel, body in FILES.items():
        text = json.dumps(body) if isinstance(body, dict) \
            else textwrap.dedent(body).lstrip()
        (bench / rel).write_text(text)
    man = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy-allreduce",
                           "source": "https://example.org/toy",
                           "file": "occl_bench/configs/toy-allreduce.json",
                           "reduced": [], "why": "throwaway"})
    man["workloads"].append({k: FILES["workloads/toy-allreduce.sum.json"][k]
                             for k in ("name", "config", "traffic", "chips",
                                       "why")})
    for m in man["per_layer"]:
        if m["name"] in ("supersteps_per_step", "step_mfu"):
            m["workloads"].append(CELL)
    man["per_layer"].append({"name": "toy_program_spans", "unit": "n",
                             "better": "lower", "source": "program_span",
                             "layer": "toy", "moves": "step_s",
                             "workloads": [CELL]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = digest(bench)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == set(FILES)

    out = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"cell": CELL}], cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": f"{tmp_path}:{tiny.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    assert got["correct"], got["checks"]
    assert got["driver"].startswith(str(bench))
    assert got["kinds"] == ["control"]
    assert got["control"]["out_gap"] > 1e-6
    assert got["calibrate"] == 0
    kinds = [json.loads(x)["kind"] for x in lines[:-1]]
    assert kinds == ["program", "control"]
    assert got["flops"] == 256
    m = got["metrics"]
    assert m["supersteps_per_step"]["value"] > 0
    assert m["step_mfu"]["value"] > 0
    spans, staged = m["toy_program_spans"]["value"]
    assert spans > 0 and staged == 2 * 256 * 4
