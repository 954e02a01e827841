#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--save-calibration PATH]

Phases (each raises on failure; the script then exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``) and builds both
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each, started
   together);
2. holds ``fused_burst`` (the superstep's whole slice burst, the main
   path's kernel) bit for bit against its plain PyTorch version on the
   card, outbox and heap_out, at the main paths' shapes (adversarial
   8x1x1 at slice 64, flat 8x1x8 and composite 16x{1,2}x8 at 1024) in
   float32 and bfloat16, over seeded descriptor sets with wrapped slots,
   partial bursts, ranks not live, invalid lanes, overlapping windows of two
   lanes, windows clamped at both ends, odd window offsets, a padded
   connector rank stride, NaN and +/-inf; times kernel and plain version
   from a CUDA graph, rotating descriptor sets over windows spread across a
   real-size heap, beside its bound; then the same for the ``[N, S]``
   ``fused_primitive`` entry (no main-path caller), timed also eagerly;
3. holds ``chunk_combine`` bit for bit against its plain version at T in
   {8, 1000, 5000, 2^22}, aligned and at an odd storage offset, float32 and
   bfloat16, ops 0..3, NaN and +/-inf entries; times the kernel, the plain
   version and the one PyTorch call computing the same function at T = 2^22,
   replayed from a CUDA graph over inputs that do not fit in L2, and the
   kernel and ``torch.add`` in turns (kernel, add, add, kernel; five
   rounds) with their spread;
4. the main paths, each driven with the kernel launch counts set to 0 just
   before it and read just after:
   a. the adversarial-orders workload (``examples/adversarial_orders.py``):
      ``run_static_order`` proves the single-FIFO baseline deadlocks, then
      the port's runtime completes it (3486 supersteps, 606 preempts);
   b. real size, flat ring: R=8 simulated ranks, two ALL_REDUCE buckets of
      2^22 float32 elements (a DDP-sized gradient bucket) submitted in
      opposite orders on odd and even ranks, 2 iterations (34491 supersteps
      and 54944 preempts per iteration);
   c. real size, composite: R=16 simulated ranks as two 8-GPU nodes
      (hierarchy (2, 8), bandwidth_groups=2, inter lanes capped at 2 of 8
      burst slices), one float32 ALL_REDUCE bucket of 2^22 elements per
      rank registered as ``"ring"`` and as ``"two_level"``, 2 iterations
      each, and ``"two_level"`` again with conn_depth 64;
   outputs checked against a float64 numpy sum (rtol/atol 1e-5);
5. the record's structural counts (``BENCH_collectives.json``): hierarchy
   flat 31 / two_level 15 and under skew 248 / 120; all-to-all flat 272 /
   two_level 100 and the adversarial a2a x all-reduce mix in 284; the
   reliability loop at R=8 (a hang, a ``DeadlockTimeout`` whose diagnosis
   names rank 5, ``evict(5)``) in 520 supersteps, bit-equal to a fresh
   7-rank runtime;
6. the record's algos sweep (R=16 grid (4, 4), 256 and 16384 elements,
   bandwidth skew 4 islands / inter cap 2; all-reduce ring / two_level /
   torus / hybrid and broadcast ring / tree) timed on the card, fitted with
   the port's cost model; prints alpha, beta, gamma and whether ``auto``
   picks the measured winner (``--save-calibration`` writes the fit);
7. one profiled launch of 32 supersteps each at the flat and the composite
   real-size configs: host wall time against device kernel time per
   superstep, the device's idle share, the 15 kernels that take the most
   device time, the chain relink's share; the ``fused_burst`` counter's rise
   in each launch must equal the profiler's count of that kernel;
8. a ``{"kernels": [...]}`` JSON line, the card line again, and the last
   line ``{"ok": true, "device": {...}}``.

It fails without a CUDA device, and when run outside a checkout of the
repository (the port's sources are not beside it).
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import re
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
# Composite real size: two 8-GPU nodes, inter-node lanes slower than NVLink.
COMP = dict(n_ranks=16, max_colls=4, max_comms=2, slice_elems=1024,
            conn_depth=32, burst_slices=8, heap_elems=1 << 24,
            bandwidth_groups=2, inter_burst_cap=2)
COMP_HIER = (2, 8)
COMP_LANES = {"ring": 1, "two_level": 2}     # max_comms of each runtime
# The composite runs: (algo, config overrides).  The last one deepens the
# connector so that a round's 31 slices no longer fill it (see PERF.md).
COMP_RUNS = (("ring", {}), ("two_level", {}),
             ("two_level", {"conn_depth": 64}))
COMP_ITERS = 2
PROFILE_STEPS = 32
TIME_ITERS = 200               # kernel calls per timing
CC_SIZES = (8, 1000, 5000, 1 << 22)
CC_BIG = 1 << 22
CC_SETS = 4                    # input sets rotated per timing (> L2 at 2^22)
# The reference's counts (hardware-independent; the CPU tests hold the port
# to the reference, and the graph-replayed daemon must match them).
ADV_SUPERSTEPS, ADV_PREEMPTS = 3486, 606
REAL_SUPERSTEPS, REAL_PREEMPTS = 34491, 54944
# BENCH_collectives.json: "hierarchy", "algos", "alltoall", "reliability".
SWEEP = dict(R=16, hier=(4, 4), slice_elems=64, burst=8)
HIER_STEPS = {"ring": 31, "two_level": 15}          # n 2048, conn 24
ALGO_STEPS = {                                       # conn 64, skew 4 / 2
    ("all_reduce", 256): {"ring": 31, "two_level": 15, "torus": 16,
                          "hybrid": 21},
    ("all_reduce", 16384): {"ring": 248, "two_level": 120, "torus": 128,
                            "hybrid": 294},
    ("broadcast", 256): {"ring": 31, "tree": 14},
    ("broadcast", 16384): {"ring": 143, "tree": 166},
}
A2A_STEPS = {"ring": 272, "two_level": 100}         # n 4096, conn 64, skew
A2A_MIX_STEPS = 284
EVICT_STEPS = 520
RECORD_ITERS = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def burst_rows(cfg: dict) -> tuple[int, int]:
    """[R*L*B, S]: the rows of one superstep's slice burst."""
    return (cfg["n_ranks"] * cfg["max_comms"] * cfg.get("burst_slices", 1),
            cfg["slice_elems"])


def runtime(core, cfg: dict, device):
    return core.OcclRuntime(core.OcclConfig(**cfg), device=device)


def free_card() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 2-3: kernels against their plain versions
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

    if not bits_equal(got, want):
        raise AssertionError(f"kernel disagrees with plain version "
                             f"({got.dtype}, {tuple(got.shape)})")
    fin = torch.isfinite(got) & torch.isfinite(want)
    diff = (got.float() - want.float()).abs()[fin]
    return float(diff.max()) if diff.numel() else 0.0


def bits_equal(got, want) -> bool:
    import torch

    ib = torch.int32 if got.dtype == torch.float32 else torch.int16
    both_nan = torch.isnan(got) & torch.isnan(want)
    return bool(((got.view(ib) == want.view(ib)) | both_nan).all())


def time_ms(fn) -> tuple[float, float]:
    """(device ms per call, host-issued ms per call) of ``fn``.

    The first number replays ``TIME_ITERS`` calls captured in one CUDA graph —
    the kernels back to back with no host issue in between, as the
    daemon's graph-replayed supersteps run them; the second times
    ``TIME_ITERS`` eager calls, which at small sizes measures the host's
    launch path.  CUDA events, after a warm-up."""
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
    return graph_ms(fn), eager


def graph_ms(fn) -> float:
    """Device ms per call of ``fn``: ``TIME_ITERS`` calls captured in one
    CUDA graph, replayed once to warm up and once under CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
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
    return a.elapsed_time(b) / TIME_ITERS


def print_ptxas(lib) -> None:
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[kernels] {lib.source.name} ptxas: {line.strip()}")


def bound_fused(n: int, s: int, dtype) -> float:
    """Least time of one fused_primitive call: 2 reads + 1 write of the
    [n, s] rows plus 16 bytes of flags per row, over the HBM rate."""
    import torch

    size = torch.finfo(dtype).bits // 8
    return (3 * n * s * size + 16 * n) / HBM_BYTES_PER_S * 1e3


def phase_fused_primitive(device) -> dict:
    import torch
    from repro_torch.kernels import fused_slice as fs

    errs, times = [], {}
    for name, cfg, dtypes in (
            ("adversarial", ADV, (torch.float32, torch.bfloat16)),
            ("real", REAL, (torch.float32, torch.bfloat16)),
            *((f"composite {a}", dict(COMP, max_comms=lanes),
               (torch.float32,)) for a, lanes in COMP_LANES.items())):
        n, s = burst_rows(cfg)
        for dtype in dtypes:
            p, l, f = kernel_inputs(n, s, dtype, device, seed=n * s)
            got = fs.fused_primitive(p, l, f)
            torch.cuda.synchronize()
            errs.append(compare_bits(got, fs.fused_primitive_plain(p, l, f)))
            k_ms, k_eager = time_ms(lambda: fs.fused_primitive(p, l, f))
            p_ms, p_eager = time_ms(lambda: fs.fused_primitive_plain(p, l, f))
            times[(name, dtype)] = (k_ms, p_ms, k_eager, p_eager)
            print(f"[kernels] fused_primitive {name} [{n}, {s}] "
                  f"{str(dtype)[6:]}: bitwise equal to plain; per call in a "
                  f"graph: kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms; issued "
                  f"eagerly: kernel {k_eager:.6f} ms, plain {p_eager:.6f} ms, "
                  f"bound {bound_fused(n, s, dtype):.7f} ms (bytes)")
    n, s = burst_rows(REAL)
    k_ms, p_ms, k_eager, p_eager = times[("real", torch.float32)]
    return {"name": "fused_primitive", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_primitive.cu",
            "replaces": "src/repro/kernels/fused_slice.py:58",
            "shape": [n, s], "dtype": "float32",
            "max_abs_err": max(errs), "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "eager_call_ms": k_eager,
            "plain_eager_call_ms": p_eager,
            "bound_ms": bound_fused(n, s, torch.float32), "bound_by": "bytes",
            "library_ms": None}


# The burst kernel's shapes: (name, R, L, B, SL, C, K, real heap_elems).
BURST_SHAPES = (
    ("adversarial", ADV["n_ranks"], 1, 1, ADV["slice_elems"],
     ADV["max_colls"], ADV["conn_depth"], ADV["heap_elems"]),
    ("flat", REAL["n_ranks"], 1, REAL["burst_slices"], REAL["slice_elems"],
     REAL["max_colls"], REAL["conn_depth"], REAL["heap_elems"]),
    *((f"composite {a}", COMP["n_ranks"], lanes, COMP["burst_slices"],
       COMP["slice_elems"], COMP["max_colls"], COMP["conn_depth"],
       COMP["heap_elems"]) for a, lanes in COMP_LANES.items()))
BURST_CHECKS = 3               # hazard descriptor sets per shape and dtype
BURST_SETS = 128               # descriptor sets rotated per timing
RING_PRIMS = (2, 5, 6, 8)      # SEND, RECV_COPY_SEND, RECV_REDUCE_SEND,
                               # RECV_REDUCE_COPY_SEND: an all-reduce ring


def burst_descriptors(rng, R, L, B, SL, C, K, H, hazards: bool):
    """Seeded numpy (lanes, tables) of one burst.  ``hazards``: wrapped
    slots, partial bursts, rank 0 not live, invalid lanes, two lanes on one
    window, offsets below 0 and past H - B*SL, odd offsets.  Otherwise the
    main path's kind of burst: full bursts of an all-reduce ring's
    primitives, distinct collectives per lane, windows at slice-aligned
    offsets spread over the heap row."""
    from repro_torch.core import primitives as P

    W = B * SL
    i32 = lambda a: np.asarray(a, np.int32)
    if hazards:
        coll = rng.randint(0, C, (R, L))
        for l in range(1, L):
            same = rng.rand(R) < 0.3
            coll[same, l] = coll[same, l - 1]
        n = rng.randint(0, B + 1, (R, L))
        prim = rng.randint(0, len(P.PRIM_RECV), (R, L))
        write = rng.rand(R, L) < 0.7
        write[0] = False
        invalid = rng.rand(R, L) < 0.15
        coll[invalid], n[invalid], write[invalid] = 0, 0, False
        in_off = rng.randint(-2 * W, H + W, (R, C))
        out_off = rng.randint(-2 * W, H + W, (R, C))
    else:
        coll = np.stack([rng.permutation(C)[:L] for _ in range(R)])
        n = np.full((R, L), B)
        prim = rng.choice(RING_PRIMS, (R, L))
        write = P.PRIM_COPY[prim] > 0
        region = (H - W) // C // SL
        in_off = (np.arange(C) * region
                  + rng.randint(0, region - 16, (R, C))) * SL
        out_off = (np.arange(C) * region
                   + rng.randint(0, region - 16, (R, C))) * SL
    lanes = dict(coll=i32(coll), tail=i32(rng.randint(0, 3 * K, (R, L))),
                 rnd=i32(rng.randint(0, 2, (R, L))),
                 sl=i32(rng.randint(0, 2, (R, L))),
                 chunk=i32(rng.randint(0, 2, (R, L))), prim=i32(prim),
                 n=i32(n), write=np.asarray(write, bool))
    tables = dict(in_off=i32(in_off), out_off=i32(out_off),
                  n_rounds=i32(rng.randint(1, 3, C)),
                  n_slices=i32(rng.randint(1, 4, C)),
                  in_chunked=i32(rng.randint(0, 2, C)),
                  out_chunked=i32(rng.randint(0, 2, C)),
                  op=i32(rng.randint(0, 4, C)))
    return lanes, tables


def burst_args(lanes, tables, device):
    import torch
    from repro_torch.core import primitives as P
    from repro_torch.kernels import fused_slice as fs

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return (fs.BurstLanes(**{f: t(v) for f, v in lanes.items()}),
            fs.BurstTables(**{f: t(v) for f, v in tables.items()},
                           prim_recv=t(P.PRIM_RECV),
                           prim_reduce=t(P.PRIM_REDUCE),
                           prim_reads_in=t(P.PRIM_READS_IN)))


def burst_bytes(lanes, B, SL, size) -> int:
    """Bytes one burst must move: the outbox rows, the slot rows and
    heap_in rows its flags read, the heap_out rows it writes."""
    from repro_torch.core import primitives as P

    prim = lanes["prim"]
    recv = P.PRIM_RECV[prim] > 0
    reduce = P.PRIM_REDUCE[prim] > 0
    reads = P.PRIM_READS_IN[prim] > 0
    need_p = recv | reduce
    need_x = reduce | (~recv & reads)
    nw = np.where(lanes["write"], np.clip(lanes["n"], 0, B), 0)
    rows_per_lane = B * (1 + need_p + need_x) + nw
    return int(rows_per_lane.sum()) * SL * size


def random_floats(shape, dtype, device, g):
    """Normal values with NaN, +inf and -inf entries sprinkled in."""
    import torch

    x = torch.randn(shape, generator=g, device=device)
    flat = x.view(-1)
    flat[3::29] = float("nan")
    flat[5::31] = float("inf")
    flat[7::37] = -float("inf")
    return x.to(dtype)


def phase_fused_burst(device) -> dict:
    """fused_burst against fused_burst_plain (outbox and heap_out), then
    timed at each main path's shape."""
    import torch
    from repro_torch.kernels import fused_slice as fs

    errs, checked = [], 0
    g = torch.Generator(device=device).manual_seed(14)
    for name, R, L, B, SL, C, K, _ in BURST_SHAPES:
        W = B * SL
        H = 5 * W + 13                     # odd row: unaligned windows
        rng = np.random.RandomState(R * 1000 + L * 100 + B)
        for dtype in (torch.float32, torch.bfloat16):
            for i in range(BURST_CHECKS):
                payload = random_floats((R, C, K, SL), dtype, device, g)
                if i == 1:                 # the inbox commit's rank stride
                    payload = torch.cat(
                        [payload.reshape(R, C * K, SL),
                         torch.zeros(R, 1, SL, dtype=dtype, device=device)],
                        1)[:, :C * K].reshape(R, C, K, SL)
                heap_in = random_floats((R, H), dtype, device, g)
                heap_out = random_floats((R, H), dtype, device, g)
                args = burst_args(*burst_descriptors(rng, R, L, B, SL, C, K,
                                                     H, True), device)
                h_k, h_p = heap_out.clone(), heap_out.clone()
                got = fs.fused_burst(payload, heap_in, h_k, B, *args)
                torch.cuda.synchronize()
                want = fs.fused_burst_plain(payload, heap_in, h_p, B, *args)
                errs.append(compare_bits(got, want))
                errs.append(compare_bits(h_k, h_p))
                checked += 1
    print(f"[kernels] fused_burst: outbox and heap_out bitwise equal to "
          f"plain in all {checked} cases ({[s[0] for s in BURST_SHAPES]}, "
          f"float32 and bfloat16, {BURST_CHECKS} hazard sets each)")
    times = {}
    for name, R, L, B, SL, C, K, heap_elems in BURST_SHAPES:
        W = B * SL
        H = heap_elems + W
        dtype = torch.float32
        rng = np.random.RandomState(7 + R + L)
        payload = torch.randn((R, C, K, SL), generator=g, device=device)
        heap_in = torch.randn((R, H), generator=g, device=device)
        heap_out = torch.zeros((R, H), device=device)
        sets = [burst_descriptors(rng, R, L, B, SL, C, K, H, False)
                for _ in range(BURST_SETS)]
        nbytes = float(np.mean([burst_bytes(ln, B, SL, 4) for ln, _ in sets]))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        dev_sets = [burst_args(ln, tb, device) for ln, tb in sets]
        rot = itertools.cycle(dev_sets)
        k_ms, _ = time_ms(lambda: fs.fused_burst(payload, heap_in, heap_out,
                                                 B, *next(rot)))
        p_ms, _ = time_ms(lambda: fs.fused_burst_plain(
            payload, heap_in, heap_out, B, *next(rot)))
        times[name] = dict(shape=[R, L, B, SL], ms=k_ms, plain_ms=p_ms,
                           bound_ms=bound)
        print(f"[kernels] fused_burst {name} R={R} L={L} B={B} SL={SL} "
              f"float32, per call in a graph over {BURST_SETS} rotating "
              f"descriptor sets on a {H}-element heap row: kernel "
              f"{k_ms:.6f} ms, plain {p_ms:.6f} ms, bound {bound:.7f} ms "
              f"(bytes, {nbytes / 1e6:.4f} MB)")
        del payload, heap_in, heap_out, dev_sets, rot
        free_card()
    flat = times["flat"]
    return {"name": "fused_burst", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_primitive.cu",
            "replaces": "src/repro/kernels/fused_slice.py:58",
            "shape": flat["shape"], "dtype": "float32",
            "max_abs_err": max(errs), "ms": flat["ms"],
            "plain_ms": flat["plain_ms"], "bound_ms": flat["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "by_shape": times}


def combine_inputs(t: int, offset: int, dtype, device, seed: int):
    """a, b: [t] views starting ``offset`` elements into their storage,
    with NaN, +inf and -inf entries."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(t + offset, generator=g, device=device).to(dtype)
    b = torch.randn(t + offset, generator=g, device=device).to(dtype)
    a[offset::97] = float("nan")
    b[offset + 3::89] = float("nan")
    b[offset + 5::83] = float("inf")
    a[offset + 7::79] = -float("inf")
    a[offset + 11::71] = float("inf")
    return a[offset:], b[offset:]


LIBRARY_CALLS = ("add", "maximum", "minimum", "mul")
TURN_ROUNDS = 5


def in_turns(kernel, library) -> dict:
    """Kernel and library call timed in turns (kernel, library, library,
    kernel) for ``TURN_ROUNDS`` rounds, each a graph of ``TIME_ITERS``
    calls.  The spread is the larger of the two ranges; the kernel counts
    as slower only when its median exceeds the library's by more."""
    ks, ls = [], []
    for _ in range(TURN_ROUNDS):
        ks.append(graph_ms(kernel))
        ls.append(graph_ms(library))
        ls.append(graph_ms(library))
        ks.append(graph_ms(kernel))
    km, lm = float(np.median(ks)), float(np.median(ls))
    spread = max(max(ks) - min(ks), max(ls) - min(ls))
    return {"kernel_ms": ks, "library_ms": ls,
            "kernel_median_ms": km, "library_median_ms": lm,
            "gap_ms": km - lm, "spread_ms": spread,
            "slower": km - lm > spread}


def phase_chunk_combine(device) -> dict:
    """chunk_combine against its plain version, then timed at 2^22."""
    import torch
    from repro_torch.kernels import chunk_combine as cc

    errs, checked = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for t in CC_SIZES:
            for offset in (0, 1):
                a, b = combine_inputs(t, offset, dtype, device, seed=t)
                for op in range(4):
                    got = cc.chunk_combine(a, b, op)
                    torch.cuda.synchronize()
                    errs.append(compare_bits(got,
                                             cc.chunk_combine_plain(a, b, op)))
                    checked += 1
    print(f"[kernels] chunk_combine: bitwise equal to plain in all {checked} "
          f"cases (T {list(CC_SIZES)}, offsets 0 and 1, float32 and "
          f"bfloat16, ops 0..3, NaN and +/-inf entries)")
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        sets = [combine_inputs(CC_BIG, 0, dtype, device, seed=s)
                for s in range(CC_SETS)]
        lib_equal = True
        for op, name in enumerate(LIBRARY_CALLS):
            a, b = sets[0]
            lib_equal &= bits_equal(cc.chunk_combine(a, b, op),
                                    getattr(torch, name)(a, b))
        rot = itertools.cycle(sets)
        k_ms, _ = time_ms(lambda: cc.chunk_combine(*next(rot), 0))
        p_ms, _ = time_ms(lambda: cc.chunk_combine_plain(*next(rot), 0))
        l_ms, _ = time_ms(lambda: torch.add(*next(rot)))
        nbytes = 3 * CC_BIG * sets[0][0].element_size()
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        turns = in_turns(lambda: cc.chunk_combine(*next(rot), 0),
                         lambda: torch.add(*next(rot)))
        times[dtype] = (k_ms, p_ms, l_ms if lib_equal else None, bound,
                        turns)
        print(f"[kernels] chunk_combine [{CC_BIG}] {str(dtype)[6:]} op 0, "
              f"per call in a graph over {CC_SETS} rotating input sets: "
              f"kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, torch.add "
              f"{l_ms:.6f} ms, bound {bound:.6f} ms (bytes); library calls "
              f"bitwise equal to the kernel for ops 0..3: {lib_equal}")
        print(f"[kernels] chunk_combine [{CC_BIG}] {str(dtype)[6:]} in turns "
              f"(kernel, add, add, kernel) x {TURN_ROUNDS}: kernel "
              f"{turns['kernel_ms']}, torch.add {turns['library_ms']}; "
              f"medians {turns['kernel_median_ms']:.6f} / "
              f"{turns['library_median_ms']:.6f} ms, kernel - add "
              f"{turns['gap_ms']:+.6f} ms, spread {turns['spread_ms']:.6f} "
              f"ms: slower beyond the spread: {turns['slower']}")
    k_ms, p_ms, l_ms, bound, turns = times[torch.float32]
    kb, pb, lb, bb, turns_b = times[torch.bfloat16]
    return {"name": "chunk_combine", "route": "cuda",
            "source": "src/repro_torch/csrc/chunk_combine.cu",
            "replaces": "src/repro/kernels/chunk_combine.py:38",
            "shape": [CC_BIG], "dtype": "float32", "op": 0,
            "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": l_ms,
            "library_call": "torch.add",
            "in_turns": turns,
            "bf16": {"ms": kb, "plain_ms": pb, "library_ms": lb,
                     "bound_ms": bb, "in_turns": turns_b},
            "smoke_launches": cc.chunk_combine.launches,
            "note": "no path of the runtime calls chunk_combine (the "
                    "reference has no caller of ops.chunk_combine either), "
                    "so its main-path launch count is 0; smoke_launches "
                    "counts the launches of this kernel phase"}


# ---------------------------------------------------------------------------
# phase 4: main paths
# ---------------------------------------------------------------------------

def phase_adversarial(device) -> dict:
    from repro_torch import core

    R, C = ADV["n_ranks"], ADV["max_colls"]
    rng = np.random.RandomState(42)
    orders = {r: list(rng.permutation(C)) for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in range(C)})
    assert static.deadlocked and static.cycle, static
    print(f"[adversarial] static single-FIFO execution deadlocks; wait-for "
          f"cycle over ranks {static.cycle}")
    rt = runtime(core, ADV, device)
    world = rt.communicator(list(range(R)))
    sizes = [64 << (i % 5) for i in range(C)]
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=s)
           for s in sizes]
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


def check_sum(rt, cid, xs: np.ndarray, R: int) -> None:
    """Every rank's output equals the float64 sum of the inputs."""
    want = xs.astype(np.float64).sum(0).astype(np.float32)
    outs = rt.read_outputs_bulk([(r, cid) for r in range(R)])
    for r in range(R):
        np.testing.assert_allclose(outs[(r, cid)], want, rtol=1e-5,
                                   atol=1e-5)


def timed_drive(rt, tag: str, it: int, per_rank_bytes: int, card: str
                ) -> dict:
    """One ``drive()`` on the host clock (ending in a device sync), with
    the supersteps and preempts it took."""
    s0 = rt.stats()
    t0 = time.perf_counter()
    rt.drive()
    secs = time.perf_counter() - t0
    st = rt.stats()
    R = rt.cfg.n_ranks
    steps = int(st["supersteps"].max()) - int(s0["supersteps"].max())
    pre = int(st["preempts"].sum()) - int(s0["preempts"].sum())
    algbw = 2 * (R - 1) / R * per_rank_bytes / secs
    print(f"[{tag}] iter {it}: {secs:.3f} s wall, {steps} supersteps "
          f"({steps / secs:.1f}/s), {pre} preempts, algbw "
          f"{algbw / 1e9:.4f} GB/s per rank [{card}]")
    return {"seconds": secs, "supersteps": steps,
            "supersteps_per_s": steps / secs, "preempts": pre,
            "algbw_GBps": algbw / 1e9}


def phase_real(device, card: str) -> dict:
    from repro_torch import core

    R = REAL["n_ranks"]
    rt = runtime(core, REAL, device)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=REAL_BUCKET)
           for _ in range(2)]
    rng = np.random.default_rng(2024)
    runs = []
    for it in range(REAL_ITERS):
        xs = [rng.standard_normal((R, REAL_BUCKET), dtype=np.float32)
              for _ in ids]
        for r in range(R):
            for b in ([0, 1] if r % 2 == 0 else [1, 0]):
                rt.submit(r, ids[b], data=xs[b][r])
        run = timed_drive(rt, "real", it, 2 * REAL_BUCKET * 4, card)
        for b, cid in enumerate(ids):
            check_sum(rt, cid, xs[b], R)
        assert (run["supersteps"], run["preempts"]) == (
            REAL_SUPERSTEPS, REAL_PREEMPTS), run
        runs.append(run)
    print("[real] outputs correct")
    return {"runs": runs, "launches": rt.launches}


def composite_runtime(core, algo: str, device, **over):
    """The composite real-size runtime with one 2^22 bucket as ``algo``."""
    R = COMP["n_ranks"]
    rt = runtime(core, dict(COMP, max_comms=COMP_LANES[algo], **over),
                 device)
    world = (rt.communicator(list(range(R))) if algo == "ring"
             else rt.logical_communicator(list(range(R))))
    cid = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=REAL_BUCKET,
                      algo=algo, hierarchy=COMP_HIER)
    return rt, cid


def phase_composite(device, card: str, fit_model) -> dict:
    """R=16 as two 8-GPU nodes: one 2^22 bucket per rank as the flat ring
    and as the two-level chain (``COMP_RUNS``), with the supersteps at
    which rank 0's stages completed."""
    from repro_torch import core
    from repro_torch.core.recorder import EV_STAGE_DONE

    R = COMP["n_ranks"]
    cfg = core.OcclConfig(**COMP)
    for name, model in (("the persisted calibration", None),
                        ("this run's fit", fit_model)):
        if model is None:
            model = core.CostModel.load()
        pick = core.select_algo("auto", core.CollKind.ALL_REDUCE,
                                REAL_BUCKET, R, COMP_HIER, cfg, model)
        print(f"[composite] auto picks {pick} under {name} "
              f"({model.source}: alpha {model.alpha:.6g}, beta "
              f"{model.beta:.6g}, gamma {model.gamma:.6g})")
    rng = np.random.default_rng(7)
    res = {}
    for algo, over in COMP_RUNS:
        tag = " ".join([algo] + [f"{k}={v}" for k, v in over.items()])
        rt, cid = composite_runtime(core, algo, device, **over)
        runs = []
        for it in range(COMP_ITERS):
            xs = rng.standard_normal((R, REAL_BUCKET), dtype=np.float32)
            rt.submit_all(cid, data={r: xs[r] for r in range(R)})
            runs.append(timed_drive(rt, f"composite {tag}", it,
                                    REAL_BUCKET * 4, card))
            check_sum(rt, cid, xs, R)
        st = rt.stats()
        start = int(st["supersteps"].max()) - runs[-1]["supersteps"]
        done = [e.step - start for e in core.events(st["flight_recorder"],
                                                    rank=0)
                if e.kind == EV_STAGE_DONE and e.step >= start]
        t = rt._tables
        slicing = [(int(t.n_slices[c]), int(t.n_rounds[c]))
                   for c in st["chains"].get(int(cid), [int(cid)])]
        print(f"[composite] {tag}: outputs correct; lane caps "
              f"{st['lane_caps'].tolist()}; (slices per round, rounds) per "
              f"stage {slicing}; rank 0's stages of the last iteration "
              f"completed at supersteps {done}")
        res[tag] = {"runs": runs, "launches": rt.launches,
                    "stage_done": done}
        del rt
        free_card()
    return res


# ---------------------------------------------------------------------------
# phase 5: the record's structural counts
# ---------------------------------------------------------------------------

def sweep_cfg(n_ranks: int, conn_depth: int, **kw) -> dict:
    return dict(n_ranks=n_ranks, max_colls=8, max_comms=3,
                slice_elems=SWEEP["slice_elems"], conn_depth=conn_depth,
                burst_slices=SWEEP["burst"], heap_elems=1 << 18,
                superstep_budget=1 << 15, **kw)


def algo_once(core, device, algo: str, kind, n: int, conn_depth: int,
              root: int = 0, **skew) -> dict:
    """``benchmarks/bench_collectives.py`` ``_algo_once`` on the port: one
    warm iteration, then ``RECORD_ITERS`` timed ones (best wall,
    mean supersteps), with the plan's cost-model features."""
    R, hier = SWEEP["R"], SWEEP["hier"]
    cfg = sweep_cfg(R, conn_depth, **skew)
    rt = runtime(core, cfg, device)
    world = (rt.communicator(list(range(R))) if algo == "ring"
             else rt.logical_communicator(list(range(R))))
    a2a = kind == core.CollKind.ALL_TO_ALL
    cid = rt.register(kind, world, n_elems=n, algo=algo, root=root,
                      hierarchy=None if algo == "ring" else hier)
    rng = np.random.RandomState(0)
    xs = [rng.randn(n).astype(np.float32) for _ in range(R)]

    def once():
        rt.submit_all(cid, data={r: xs[r] for r in range(R)})
        rt.drive()

    once()
    if a2a:
        c = n // R
        np.testing.assert_array_equal(
            rt.read_output(0, cid), np.concatenate([x[:c] for x in xs]))
    else:
        want = xs[root] if kind == core.CollKind.BROADCAST else \
            np.sum(xs, axis=0)
        check = root if kind in (core.CollKind.REDUCE,
                                 core.CollKind.BROADCAST) else 0
        np.testing.assert_allclose(rt.read_output(check, cid), want,
                                   rtol=1e-4, atol=1e-4)
    s0 = int(rt.stats()["supersteps"].max())
    wall = float("inf")
    for _ in range(RECORD_ITERS):
        t0 = time.perf_counter()
        once()
        wall = min(wall, time.perf_counter() - t0)
    steps = (int(rt.stats()["supersteps"].max()) - s0) / RECORD_ITERS
    feats = core.plan_features(rt.cfg, kind, n, R,
                               None if algo == "ring" else hier, algo,
                               root=root)
    return {"wall": wall, "supersteps": steps,
            "features": {k: feats[k] for k in ("supersteps", "bytes",
                                               "stages")}}


def a2a_mix(core, device) -> float:
    """The adversarial a2a x all-reduce mix (``_a2a_contention_once``):
    mean supersteps per iteration after a warm one."""
    R, n = 8, 2048
    orders = {r: list(np.random.RandomState(r).permutation(3))
              for r in range(R)}
    static = core.run_static_order(orders,
                                   {c: list(range(R)) for c in range(3)})
    assert static.deadlocked, static
    rt = runtime(core, dict(sweep_cfg(R, 64), max_comms=1), device)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n),
           rt.register(core.CollKind.ALL_TO_ALL, world, n_elems=n),
           rt.register(core.CollKind.ALL_REDUCE, world, n_elems=n)]
    rng = np.random.RandomState(1)
    xs = {c: [rng.randn(n).astype(np.float32) for _ in range(R)]
          for c in range(3)}

    def once():
        for r in range(R):
            for c in orders[r]:
                rt.submit(r, ids[c], data=xs[c][r])
        rt.drive()

    once()
    g = n // R
    for c in (0, 1):
        np.testing.assert_array_equal(
            rt.read_output(0, ids[c]),
            np.concatenate([xs[c][o][:g] for o in range(R)]))
    np.testing.assert_allclose(rt.read_output(0, ids[2]),
                               np.sum(xs[2], axis=0), rtol=1e-4, atol=1e-4)
    s0 = int(rt.stats()["supersteps"].max())
    for _ in range(RECORD_ITERS):
        once()
    return (int(rt.stats()["supersteps"].max()) - s0) / RECORD_ITERS


def evict_loop(core, device) -> dict:
    """``examples/elastic_shrink.py``'s loop at the record's evict config
    (R=8, 4 all-reduces of 4096, rank 5 dies): a healthy round, the wedged
    round times out with a diagnosis naming rank 5, ``evict(5)`` replays
    the survivors' work; the result must equal a fresh 7-rank runtime's."""
    R, C, n, dead = 8, 4, 4096, 5
    rng = np.random.RandomState(0)
    payload = {(r, c): rng.randint(0, 1 << 10, n).astype(np.float32)
               for r in range(R) for c in range(C)}

    def build(n_ranks):
        rt = runtime(core, dict(n_ranks=n_ranks, max_colls=C + 2,
                                max_comms=1, slice_elems=64, conn_depth=8,
                                heap_elems=1 << 17,
                                superstep_budget=1 << 15), device)
        comm = rt.communicator(range(n_ranks))
        return rt, [rt.register(core.CollKind.ALL_REDUCE, comm, n_elems=n)
                    for _ in range(C)]

    rt, hs = build(R)
    for c, h in enumerate(hs):
        for r in range(R):
            h.submit(r, prio=c, data=payload[(r, c)])
    rt.drive()
    for c, h in enumerate(hs):
        for r in range(R):
            if r != dead:
                h.submit(r, prio=c, data=payload[(r, c)])
    try:
        rt.drive(max_launches=2)
    except core.DeadlockTimeout as e:
        holders = e.diagnosis.holders
    else:
        raise AssertionError("the wedged round did not time out")
    assert holders == [dead], holders
    report = rt.evict(dead)
    steps = int(rt.stats()["supersteps"].max())
    survivors = [r for r in range(R) if r != dead]
    fresh, fhs = build(R - 1)
    for c, h in enumerate(fhs):
        for new_r, old in enumerate(survivors):
            h.submit(new_r, prio=c, data=payload[(old, c)])
    fresh.drive()
    bit_equal = all(np.array_equal(hs[c].read(r), fhs[c].read(r))
                    for c in range(C) for r in range(R - 1))
    return {"holders": holders, "report": report, "supersteps": steps,
            "fresh_supersteps": int(fresh.stats()["supersteps"].max()),
            "bit_equal": bit_equal}


def record_counts(device) -> dict:
    """The record's hierarchy, all-to-all and reliability counts."""
    from repro_torch import core

    AR, A2A = core.CollKind.ALL_REDUCE, core.CollKind.ALL_TO_ALL
    out = {"hierarchy": {a: algo_once(core, device, a, AR, 2048, 24)
                         ["supersteps"] for a in HIER_STEPS},
           "alltoall": {a: algo_once(core, device, a, A2A, 4096, 64,
                                     bandwidth_groups=4, inter_burst_cap=2)
                        ["supersteps"] for a in A2A_STEPS},
           "alltoall_mix": a2a_mix(core, device),
           "evict": evict_loop(core, device)}
    return out


def phase_record(device) -> dict:
    res = record_counts(device)
    ev = res["evict"]
    print(f"[record] hierarchy R=16 (4, 4) n 2048: flat "
          f"{res['hierarchy']['ring']:g} / two_level "
          f"{res['hierarchy']['two_level']:g} supersteps; all-to-all "
          f"n 4096: flat {res['alltoall']['ring']:g} / two_level "
          f"{res['alltoall']['two_level']:g}; adversarial a2a mix "
          f"{res['alltoall_mix']:g}")
    print(f"[record] evict: diagnosis names rank(s) {ev['holders']}; "
          f"evict(5) -> R={ev['report']['n_ranks']}, replayed "
          f"{ev['report']['replayed']}, {ev['supersteps']} supersteps "
          f"(fresh 7-rank runtime {ev['fresh_supersteps']}), bit-equal "
          f"{ev['bit_equal']}")
    assert res["hierarchy"] == HIER_STEPS, res["hierarchy"]
    assert res["alltoall"] == A2A_STEPS, res["alltoall"]
    assert res["alltoall_mix"] == A2A_MIX_STEPS, res["alltoall_mix"]
    assert ev["supersteps"] == ev["fresh_supersteps"] == EVICT_STEPS, ev
    assert ev["bit_equal"], ev
    return res


# ---------------------------------------------------------------------------
# phase 6: the algos sweep and the cost-model fit
# ---------------------------------------------------------------------------

def algos_sweep(device) -> dict:
    """{(kind label, n): {algo: algo_once record}} over the record's
    sweep, with the record's superstep counts asserted."""
    from repro_torch import core

    kinds = {"all_reduce": core.CollKind.ALL_REDUCE,
             "broadcast": core.CollKind.BROADCAST}
    out = {}
    for (label, n), want in ALGO_STEPS.items():
        got = {a: algo_once(core, device, a, kinds[label], n, 64,
                            bandwidth_groups=4, inter_burst_cap=2)
               for a in want}
        steps = {a: got[a]["supersteps"] for a in want}
        assert steps == want, (label, n, steps, want)
        out[(label, n)] = got
    return out


def phase_algos(device, card: str, save_path) -> "object":
    from repro_torch import core

    sweep = algos_sweep(device)
    samples = []
    for (label, n), got in sweep.items():
        for a, rec in got.items():
            samples.append(dict(rec["features"], wall=rec["wall"],
                                tag=f"{label}/{n}/{a}"))
            print(f"[algos] {label} n={n} {a}: {rec['supersteps']:g} "
                  f"supersteps, best wall {rec['wall']:.6f} s [{card}]")
    model = core.fit(samples)
    print(f"[algos] fit over {len(samples)} samples: alpha "
          f"{model.alpha:.6g} s/superstep, beta {model.beta:.6g} s/byte, "
          f"gamma {model.gamma:.6g} s/stage [{card}]")
    picks = {}
    kinds = {"all_reduce": core.CollKind.ALL_REDUCE,
             "broadcast": core.CollKind.BROADCAST}
    cfg = core.OcclConfig(**sweep_cfg(SWEEP["R"], 64, bandwidth_groups=4,
                                      inter_burst_cap=2))
    for (label, n), got in sweep.items():
        best = min(got, key=lambda a: got[a]["wall"])
        pick = core.select_algo("auto", kinds[label], n, SWEEP["R"],
                                SWEEP["hier"], cfg, model)
        picks[f"{label}/{n}"] = {"pick": pick, "best_algo": best}
        print(f"[algos] auto picks {pick} for {label} n={n}; measured "
              f"winner {best}: {'same' if pick == best else 'DIFFERENT'}")
    if save_path is not None:
        name, limit = [s.strip() for s in card.split(",")]
        model.save(save_path, extra={
            "n_samples": len(samples), "card": name, "power_limit": limit,
            "source_script": "chip_smoke.py", "picks": picks,
            "samples": samples})
        print(f"[algos] saved the fit to {save_path}")
    return model


# ---------------------------------------------------------------------------
# phase 7: where the time goes (short profiled launches at real size)
# ---------------------------------------------------------------------------

BURST_KERNEL = re.compile(r"\bfused_burst_kernel<")
TOP_KERNELS = 15


def profile_launch(rt, tag: str, card: str) -> dict:
    """Profile one ``launch_once`` (data already on the device): host wall
    time against device kernel time per superstep, the device's idle share,
    the kernel count and the kernels that take the most device time.
    Raises unless the ``fused_burst`` counter rose by exactly the number of
    burst kernels (matched by their name) the profiler saw run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_slice as fs

    rt.launch_once()                    # flushes the payloads, warms up
    torch.cuda.synchronize()
    counted = fs.fused_burst.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.launch_once()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = fs.fused_burst.launches - counted
    ran = rt.launch_history[-1]["launch_steps"]
    dev_us = n_kernels = burst_us = 0.0
    traced = 0
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev_us += us
            n_kernels += e.count
            kernels.append((us, e.count, e.key))
            if BURST_KERNEL.search(e.key):
                burst_us += us
                traced += e.count
    print(f"[profile] {tag}: fused_burst launches in the profiled launch: "
          f"counter {counted}, profiler {traced}")
    assert counted == traced > 0, (counted, traced)
    res = {"supersteps": ran, "wall_ms_per_superstep": wall * 1e3 / ran,
           "device_ms_per_superstep": dev_us / 1e3 / ran,
           "device_idle_share": 1.0 - dev_us / 1e6 / wall,
           "kernels_per_superstep": n_kernels / ran,
           "fused_burst_device_ms_per_superstep": burst_us / 1e3 / ran,
           "top": [(k[:120], count / ran, us / 1e3 / ran) for us, count, k
                   in sorted(kernels, reverse=True)[:TOP_KERNELS]]}
    print(f"[profile] {tag} launch of {ran} supersteps: "
          f"{res['wall_ms_per_superstep']:.4f} ms wall per superstep, "
          f"{res['device_ms_per_superstep']:.4f} ms device kernel time "
          f"({res['kernels_per_superstep']:.1f} kernels, fused_burst "
          f"{res['fused_burst_device_ms_per_superstep']:.5f} ms), "
          f"device idle share {res['device_idle_share']:.4f} [{card}]")
    for i, (key, count, ms) in enumerate(res["top"]):
        print(f"[profile] {tag} top {i + 1}: {ms:.6f} ms and {count:.2f} "
              f"launches per superstep: {key}")
    return res


def phase_profile(device, card: str) -> dict:
    import torch
    from repro_torch import core
    from repro_torch.core import daemon

    short = dict(superstep_budget=PROFILE_STEPS, quit_threshold=PROFILE_STEPS)
    R = REAL["n_ranks"]
    rt = runtime(core, dict(REAL, **short), device)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=REAL_BUCKET)
           for _ in range(2)]
    x = np.ones(REAL_BUCKET, np.float32)
    for r in range(R):
        for b in ([0, 1] if r % 2 == 0 else [1, 0]):
            rt.submit(r, ids[b], data=x)
    flat = profile_launch(rt, "real size, flat", card)
    del rt
    free_card()

    rt, cid = composite_runtime(core, "two_level", device, **short)
    rt.submit_all(cid, data=np.ones(REAL_BUCKET, np.float32))
    comp = profile_launch(rt, "composite real size, two_level", card)
    # The relink alone, at the same shapes: every edge fired on every rank
    # (its cost does not depend on which ranks fire).
    st = rt.state
    plan = daemon._edge_plan(daemon._relink_edges(rt._tables), device)
    fired = torch.ones((COMP["n_ranks"], COMP["max_colls"]),
                       dtype=torch.bool, device=device)
    relink_ms, _ = time_ms(lambda: daemon._apply_relink(
        plan, fired, st.heap_in, st.heap_out))
    spans = [span for _, _, span, *_ in plan]
    moved = 3 * COMP["n_ranks"] * sum(spans) * 4
    comp["relink_ms_per_superstep"] = relink_ms
    comp["relink_share"] = relink_ms / comp["device_ms_per_superstep"]
    print(f"[profile] chain relink: {len(plan)} edges of spans {spans} "
          f"per rank, {moved / 1e6:.1f} MB moved per superstep, "
          f"{relink_ms:.5f} ms per superstep ({moved / relink_ms / 1e6:.0f}"
          f" GB/s), {comp['relink_share']:.4f} of the two-level superstep's"
          f" device time [{card}]")
    del rt, st
    free_card()
    return {"flat": flat, "composite": comp}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-calibration", type=pathlib.Path,
                        default=None, help="write the algos sweep's fit "
                        "(CostModel.save) to this file")
    args = parser.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)   # phase lines survive a kill

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_combine as cc
    from repro_torch.kernels import fused_slice as fs

    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all([fs.LIBRARY, cc.LIBRARY])
    print(f"[kernels] built fused_primitive.cu (fused_burst, "
          f"fused_primitive) and chunk_combine.cu in "
          f"{time.perf_counter() - t0:.1f} s (sm_90a, one nvcc each)")
    print_ptxas(fs.LIBRARY)
    print_ptxas(cc.LIBRARY)

    burst_entry = phase_fused_burst(device)
    fused_entry = phase_fused_primitive(device)
    combine_entry = phase_chunk_combine(device)

    counters = (fs.fused_burst, fs.fused_primitive, cc.chunk_combine)
    paths = {}

    def main_path(name, fn):
        for k in counters:
            k.launches = 0
        res = fn()
        paths[name] = tuple(k.launches for k in counters)
        print(f"[path] {name}: fused_burst launches {paths[name][0]}, "
              f"fused_primitive launches {paths[name][1]}, chunk_combine "
              f"launches {paths[name][2]}")
        assert paths[name][0] > 0, (name, paths[name])
        return res

    adv = main_path("adversarial", lambda: phase_adversarial(device))
    assert paths["adversarial"][0] >= adv["supersteps"]
    real = main_path("real", lambda: phase_real(device, card))
    assert paths["real"][0] >= sum(r["supersteps"] for r in real["runs"])
    free_card()
    phase_record(device)
    model = phase_algos(device, card, args.save_calibration)
    comp = main_path("composite", lambda: phase_composite(device, card,
                                                          model))
    assert paths["composite"][0] >= sum(
        r["supersteps"] for v in comp.values() for r in v["runs"])
    phase_profile(device, card)

    entries = (burst_entry, fused_entry, combine_entry)
    for i, entry in enumerate(entries):
        entry["launches"] = sum(p[i] for p in paths.values())
        entry["launches_by_path"] = {k: p[i] for k, p in paths.items()}
    fused_entry["note"] = ("the [N, S] counterpart of the Pallas contract; "
                           "no runtime path calls it since the scheduler's "
                           "burst is one fused_burst launch")
    print(card)
    print(json.dumps({"kernels": list(entries)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
