#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the ``fused_primitive`` CUDA kernel from ``src/repro_torch/csrc``
   and holds it bit for bit against its plain PyTorch version on the card,
   at the main path's shapes ([R*L*B, S] of the two configs below) in
   float32 and bfloat16, NaN and +/-inf rows included; times both with CUDA
   events, replayed from a CUDA graph and issued eagerly;
3. the adversarial-orders workload (``examples/adversarial_orders.py``):
   ``run_static_order`` proves the single-FIFO baseline deadlocks, then the
   port's runtime on ``cuda`` completes it, outputs checked against a numpy
   sum (rtol 1e-4, atol 1e-5);
4. real size: R=8 simulated ranks, two ALL_REDUCE buckets of 2^22 float32
   elements each (16 MiB per rank, a PyTorch DDP-sized gradient bucket),
   submitted in opposite orders on odd and even ranks (a single-FIFO library
   deadlocks on that), 2 iterations; outputs checked against a float64
   numpy sum cast to float32 (rtol 1e-5, atol 1e-5: the ring sums in float32
   in another order);
5. one profiled launch of 32 supersteps at the real-size config: host wall
   time against device kernel time per superstep, and the device's idle
   share; the launch counter's rise in that launch (CUDA-graph replays
   included) must equal the ``fused_primitive`` kernels the profiler saw;
6. a ``{"kernels": [...]}`` JSON line: per kernel its launches on the main
   path (phases 3 and 4, counts zeroed just before, read just after), its
   time, its plain version's time, its bound and its max abs error;
7. the last line: ``{"ok": true, "device": {...}}``.

It fails without a CUDA device, and when run outside a checkout of the
repository (the port's sources are not beside it).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
ADV = dict(n_ranks=8, max_colls=8, max_comms=1, slice_elems=64,
           conn_depth=4, heap_elems=1 << 16, superstep_budget=1 << 15)
REAL = dict(n_ranks=8, max_colls=2, max_comms=1, slice_elems=1024,
            conn_depth=32, burst_slices=8, heap_elems=1 << 24)
REAL_BUCKET = 1 << 22
ADV_ITERS, REAL_ITERS = 3, 2
PROFILE_STEPS = 32
TIME_ITERS = 200               # kernel calls per timing
# The reference's superstep and preempt counts for the adversarial phase
# (hardware-independent; tests/test_torch_adversarial.py holds the port to
# the reference on the CPU, and the graph-replayed daemon must match them).
ADV_SUPERSTEPS, ADV_PREEMPTS = 3486, 606


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def burst_rows(cfg: dict) -> tuple[int, int]:
    """[R*L*B, S]: the fused_primitive shape the scheduler launches."""
    return (cfg["n_ranks"] * cfg["max_comms"] * cfg.get("burst_slices", 1),
            cfg["slice_elems"])


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(n: int, s: int, dtype, device, seed: int):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(n, s, generator=g, device=device).to(dtype)
    l = torch.randn(n, s, generator=g, device=device).to(dtype)
    # Every (recv, reduce, reads_in) pattern x op, cycling over the rows.
    i = torch.arange(n, device=device, dtype=torch.int32)
    flags = torch.stack([i & 1, (i >> 1) & 1, (i >> 2) & 1, (i >> 3) % 4],
                        dim=1).contiguous()
    nan, inf = float("nan"), float("inf")
    for r in range(0, n, 4):            # NaN and +/-inf rows
        p[r, 1::7] = nan
        l[min(r + 1, n - 1), 2::5] = inf
        l[min(r + 2, n - 1), 3::5] = -inf
        p[min(r + 3, n - 1), 0::3] = -inf
    return p, l, flags


def compare_bits(got, want) -> float:
    """Raise unless bitwise equal (NaN == NaN whatever its payload bits);
    returns the max abs error over the finite positions."""
    import torch

    ib = torch.int32 if got.dtype == torch.float32 else torch.int16
    both_nan = torch.isnan(got) & torch.isnan(want)
    same = (got.view(ib) == want.view(ib)) | both_nan
    if not bool(same.all()):
        bad = int((~same).sum())
        raise AssertionError(f"kernel disagrees with plain version at {bad} "
                             f"of {same.numel()} elements ({got.dtype})")
    fin = torch.isfinite(got) & torch.isfinite(want)
    diff = (got.float() - want.float()).abs()[fin]
    return float(diff.max()) if diff.numel() else 0.0


def time_ms(fn) -> tuple[float, float]:
    """(device ms per call, host-issued ms per call) of ``fn``.

    The first number replays ``TIME_ITERS`` calls captured in one CUDA graph —
    the kernels back to back with no host issue in between, as the
    daemon's graph-replayed supersteps run them; the second times
    ``TIME_ITERS`` eager calls, which at these sizes measures the host's launch
    path.  CUDA events, after a warm-up."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(TIME_ITERS):
        fn()
    b.record()
    torch.cuda.synchronize()
    eager = a.elapsed_time(b) / TIME_ITERS
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(TIME_ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / TIME_ITERS, eager


def phase_kernels(device) -> dict:
    import torch
    from repro_torch.kernels import fused_slice as fs

    t0 = time.perf_counter()
    fs.build()
    print(f"[kernels] built fused_primitive in {time.perf_counter() - t0:.1f}"
          f" s (sm_90a)")
    for line in fs.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[kernels] ptxas: {line.strip()}")
    errs, times = [], {}
    for name, cfg in (("adversarial", ADV), ("real", REAL)):
        n, s = burst_rows(cfg)
        for dtype in (torch.float32, torch.bfloat16):
            p, l, f = kernel_inputs(n, s, dtype, device, seed=n * s)
            got = fs.fused_primitive(p, l, f)
            torch.cuda.synchronize()
            err = compare_bits(got, fs.fused_primitive_plain(p, l, f))
            errs.append(err)
            k_ms, k_eager = time_ms(lambda: fs.fused_primitive(p, l, f))
            p_ms, p_eager = time_ms(lambda: fs.fused_primitive_plain(p, l, f))
            times[(name, dtype)] = (k_ms, p_ms, k_eager, p_eager)
            print(f"[kernels] {name} [{n}, {s}] {str(dtype)[6:]}: bitwise "
                  f"equal to plain; per call in a graph: kernel {k_ms:.6f} "
                  f"ms, plain {p_ms:.6f} ms; issued eagerly: kernel "
                  f"{k_eager:.6f} ms, plain {p_eager:.6f} ms")
    n, s = burst_rows(REAL)
    moved = 3 * n * s * 4 + n * 4 * 4     # 2 reads + 1 write f32, + flags
    k_ms, p_ms, k_eager, p_eager = times[("real", torch.float32)]
    return {"name": "fused_primitive", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_primitive.cu",
            "replaces": "src/repro/kernels/fused_slice.py:58",
            "shape": [n, s], "dtype": "float32",
            "max_abs_err": max(errs), "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "eager_call_ms": k_eager,
            "plain_eager_call_ms": p_eager,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: adversarial orders at the example's size
# ---------------------------------------------------------------------------

def phase_adversarial(device) -> dict:
    from repro_torch.core import (CollKind, OcclConfig, OcclRuntime,
                                  run_static_order)

    R, C = ADV["n_ranks"], ADV["max_colls"]
    rng = np.random.RandomState(42)
    orders = {r: list(rng.permutation(C)) for r in range(R)}
    static = run_static_order(orders, {c: list(range(R)) for c in range(C)})
    assert static.deadlocked and static.cycle, static
    print(f"[adversarial] static single-FIFO execution deadlocks; wait-for "
          f"cycle over ranks {static.cycle}")
    rt = OcclRuntime(OcclConfig(**ADV), device=device)
    world = rt.communicator(list(range(R)))
    sizes = [64 << (i % 5) for i in range(C)]
    ids = [rt.register(CollKind.ALL_REDUCE, world, n_elems=s) for s in sizes]
    t0 = time.perf_counter()
    for it in range(ADV_ITERS):
        data = {i: [rng.randn(sizes[i]).astype(np.float32) for _ in range(R)]
                for i in range(C)}
        for r in range(R):
            for slot in orders[r]:
                rt.submit(r, ids[slot], data=data[slot][r])
        rt.drive()
        outs = rt.read_outputs_bulk([(r, ids[i]) for i in range(C)
                                     for r in range(R)])
        for i in range(C):
            want = sum(data[i])
            for r in range(R):
                np.testing.assert_allclose(outs[(r, ids[i])], want,
                                           rtol=1e-4, atol=1e-5)
    secs = time.perf_counter() - t0
    st = rt.stats()
    res = {"supersteps": int(st["supersteps"].max()),
           "preempts": int(st["preempts"].sum()),
           "completed": int(st["completed"].sum()),
           "launches": rt.launches, "seconds": secs}
    print(f"[adversarial] OCCL completed {res['completed']} all-reduces "
          f"correctly in {res['supersteps']} supersteps, {res['preempts']} "
          f"preempts, {res['launches']} launches, {secs:.3f} s")
    assert (res["supersteps"], res["preempts"]) == (
        ADV_SUPERSTEPS, ADV_PREEMPTS), res
    return res


# ---------------------------------------------------------------------------
# phase 4: real size
# ---------------------------------------------------------------------------

def phase_real(device, card: str) -> dict:
    from repro_torch.core import CollKind, OcclConfig, OcclRuntime

    R = REAL["n_ranks"]
    rt = OcclRuntime(OcclConfig(**REAL), device=device)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(CollKind.ALL_REDUCE, world, n_elems=REAL_BUCKET)
           for _ in range(2)]
    rng = np.random.default_rng(2024)
    runs = []
    for it in range(REAL_ITERS):
        xs = [rng.standard_normal((R, REAL_BUCKET), dtype=np.float32)
              for _ in ids]
        for r in range(R):
            order = [0, 1] if r % 2 == 0 else [1, 0]
            for b in order:
                rt.submit(r, ids[b], data=xs[b][r])
        s0 = rt.stats()
        steps0 = int(s0["supersteps"].max())
        pre0 = int(s0["preempts"].sum())
        t0 = time.perf_counter()
        rt.drive()
        secs = time.perf_counter() - t0
        st = rt.stats()
        steps = int(st["supersteps"].max()) - steps0
        pre = int(st["preempts"].sum()) - pre0
        for b, cid in enumerate(ids):
            want = xs[b].astype(np.float64).sum(0).astype(np.float32)
            outs = rt.read_outputs_bulk([(r, cid) for r in range(R)])
            for r in range(R):
                np.testing.assert_allclose(outs[(r, cid)], want, rtol=1e-5,
                                           atol=1e-5)
        per_rank = 2 * REAL_BUCKET * 4
        algbw = 2 * (R - 1) / R * per_rank / secs
        runs.append({"seconds": secs, "supersteps": steps,
                     "supersteps_per_s": steps / secs, "preempts": pre,
                     "algbw_GBps": algbw / 1e9})
        print(f"[real] iter {it}: {secs:.3f} s wall, {steps} supersteps "
              f"({steps / secs:.1f}/s), {pre} preempts, algbw "
              f"{algbw / 1e9:.4f} GB/s per rank; outputs correct "
              f"[{card}]")
    return {"runs": runs, "launches": rt.launches}


# ---------------------------------------------------------------------------
# phase 5: where the time goes (one short profiled launch at real size)
# ---------------------------------------------------------------------------

def phase_profile(device, card: str) -> dict:
    """Profile one launch of ``PROFILE_STEPS`` supersteps at the real-size
    config (data already on the device): host wall time against device
    kernel time per superstep, the device's idle share and the kernel
    count.  Raises unless the launch counter rose by exactly the number of
    ``fused_primitive`` kernels the profiler saw run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import CollKind, OcclConfig, OcclRuntime
    from repro_torch.kernels import fused_slice as fs

    cfg = dict(REAL, superstep_budget=PROFILE_STEPS,
               quit_threshold=PROFILE_STEPS)
    R = cfg["n_ranks"]
    rt = OcclRuntime(OcclConfig(**cfg), device=device)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(CollKind.ALL_REDUCE, world, n_elems=REAL_BUCKET)
           for _ in range(2)]
    x = np.ones(REAL_BUCKET, np.float32)
    for r in range(R):
        for b in ([0, 1] if r % 2 == 0 else [1, 0]):
            rt.submit(r, ids[b], data=x)
    rt.launch_once()                    # flushes the payloads, warms up
    torch.cuda.synchronize()
    counted = fs.fused_primitive.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.launch_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = fs.fused_primitive.launches - counted
    ran = rt.launch_history[-1]["launch_steps"]
    dev_us = n_kernels = fused_us = 0.0
    traced = 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev_us += us
            n_kernels += e.count
            if "fused_primitive" in e.key:
                fused_us += us
                traced += e.count
    print(f"[profile] fused_primitive launches in the profiled launch: "
          f"counter {counted}, profiler {traced}")
    assert counted == traced > 0, (counted, traced)
    res = {"supersteps": ran, "wall_ms_per_superstep": wall * 1e3 / ran,
           "device_ms_per_superstep": dev_us / 1e3 / ran,
           "device_idle_share": 1.0 - dev_us / 1e6 / wall,
           "kernels_per_superstep": n_kernels / ran,
           "fused_primitive_device_ms_per_superstep": fused_us / 1e3 / ran}
    print(f"[profile] real-size launch of {ran} supersteps: "
          f"{res['wall_ms_per_superstep']:.4f} ms wall per superstep, "
          f"{res['device_ms_per_superstep']:.4f} ms device kernel time "
          f"({res['kernels_per_superstep']:.1f} kernels, fused_primitive "
          f"{res['fused_primitive_device_ms_per_superstep']:.5f} ms), "
          f"device idle share {res['device_idle_share']:.4f} [{card}]")
    return res


def main() -> int:
    import torch

    sys.stdout.reconfigure(line_buffering=True)   # phase lines survive a kill

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import fused_slice as fs

    device = torch.device("cuda")
    card = card_line()
    print(card)
    from torch.utils.cpp_extension import is_ninja_available
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ninja "
          f"{is_ninja_available()}")

    entry = phase_kernels(device)

    fs.fused_primitive.launches = 0
    adv = phase_adversarial(device)
    adv_launches = fs.fused_primitive.launches
    assert adv_launches >= adv["supersteps"], (adv_launches, adv)
    real = phase_real(device, card)
    launches = fs.fused_primitive.launches
    real_launches = launches - adv_launches
    steps = sum(r["supersteps"] for r in real["runs"])
    assert real_launches >= steps, (real_launches, steps)
    print(f"[path] fused_primitive launches: adversarial {adv_launches} "
          f"(supersteps {adv['supersteps']}), real {real_launches} "
          f"(supersteps {steps})")

    phase_profile(device, card)
    entry["launches"] = launches
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
