"""The readings that the limits of ``correct`` are set from.

    python3 occl_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--stand-in-seeds 4,5,6] [--out FILE]

For each of ``--seeds`` it runs the cell's program path as a run does, with a
window of no length (a training cell: the steps the reference follows; a
MoE cell: one step), and prints the
readings of the comparison with the reference.  For each of
``--stand-in-seeds`` it prints the readings of the control (the reference
one precision below the configuration's) and, for a training cell, of each
fault the cell can have (``harness/standins.py``).  One JSON object per
line, on standard output and appended to ``--out``.  Needs a CUDA card;
the benchmark's runs never call it.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--stand-in-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from occl_bench.harness import cell, manifest, standins
    from occl_bench.harness.window import Window, cell_config, free

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    man = manifest.load()
    entry = manifest.cell(man, args.workload)
    wl = manifest.workload(args.workload)
    cfg = cell_config(manifest.config(man, entry["config"]), wl)
    drive = manifest.driver(wl["driver"]).run
    seeds = [int(s) for s in args.seeds.split(",") if s]
    stand = [int(s) for s in args.stand_in_seeds.split(",") if s]

    def emit(rec: dict) -> None:
        line = json.dumps(dict(rec, workload=args.workload))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in seeds:
        t0 = time.perf_counter()
        out = drive(cell.context(cfg, wl, seed, args.device,
                                 Window(0.0, args.device)))
        out.release()
        emit({"kind": "program", "seed": seed, "readings": out.check(),
              "seconds": time.perf_counter() - t0})
        del out
        free()
    for seed in stand:
        for kind in standins.kinds(cfg):
            t0 = time.perf_counter()
            emit({"kind": kind, "seed": seed,
                  "readings": standins.read(cfg, wl, seed, args.device,
                                            kind),
                  "seconds": time.perf_counter() - t0})
            free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
