"""Run one cell of the port's benchmark on this machine's CUDA card(s).

    python3 occl_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
per-layer metrics are found by name through ``BENCHMARK.json``.  With
``--trace 0`` the result's metrics are the end-to-end ones (``step_s``,
``setup_s``); with ``--trace 1`` the per-layer ones, read from host-clock
spans around the program's calls, the runtime's counters and one profiled
slice of a step.  The last line of standard output is the result as JSON;
the numbers compared with the reference follow on standard error, each
beside its limit.  Exits 2 without a CUDA card (or with fewer than the cell
asks for) and 3 if a forbidden package got loaded; neither prints a result.

Before anything else the run has glibc keep the host memory it frees
(``keep_freed_host_memory``): a step's host staging buffers, hundreds of MB
drawn fresh every step, then reuse pages already in the process instead of
being mapped and faulted in again page by page.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4   # glibc's mallopt parameters


def keep_freed_host_memory(libc=None) -> str:
    """Have glibc serve every allocation from its heap (``M_MMAP_MAX`` 0)
    and never hand the heap's free top back (``M_TRIM_THRESHOLD`` at its
    largest), so that memory this process frees is reused without a fresh
    mapping and its page faults.  Acts on this process alone; returns what
    it did, for standard error."""
    try:
        mallopt = (libc or ctypes.CDLL(None)).mallopt
    except (OSError, AttributeError):
        return "host allocator left as it is: no mallopt"
    if mallopt(M_MMAP_MAX, 0) != 1 \
            or mallopt(M_TRIM_THRESHOLD, 2**31 - 1) != 1:
        return "host allocator left as it is: mallopt refused"
    return "host allocator keeps what it frees: M_MMAP_MAX 0, " \
        "M_TRIM_THRESHOLD 2**31-1"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(res: dict, trace: bool, chips: int, kind: str) -> dict:
    if trace:
        metrics = res["metrics"]
    else:
        metrics = {"step_s": {"value": res["step_s"], "unit": "s"},
                   "setup_s": {"value": res["setup_s"], "unit": "s"}}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if trace and "busy_s" in res:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    print(f"[bench] {keep_freed_host_memory()}", file=sys.stderr)
    import torch

    from occl_bench.harness import cell, manifest

    man = manifest.load()
    entry = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = cell.run(manifest.config(man, entry["config"]),
                   manifest.workload(args.workload), args.seed,
                   args.seconds, "cuda", T_START,
                   manifest.metrics_for(man, args.workload)
                   if args.trace else (), bool(args.trace))
    bad = cell.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(res, bool(args.trace), entry["chips"],
                       torch.cuda.get_device_name(0))
    print(f"[bench] readings {json.dumps(res['readings'])}; reference "
          f"check {res['check_s']:.3f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
