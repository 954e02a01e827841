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
   8x1x1 at slice 64, flat 8x1x8, composite 16x{1,2}x8 and the ViT
   training cell's 4x1x8 at 1024, the record's dense grad-sync cell's
   4x1x8 at 512, the serving cell's 4x1x1 at 64, the MoE cells' 4x1x1 at
   128 and at 8192, the mesh backend's per-rank 1x1x8 at 1024) in
   float32 and bfloat16, over seeded descriptor sets with wrapped slots,
   partial bursts, ranks not live, invalid lanes, overlapping windows of two
   lanes, windows clamped at both ends, odd window offsets, a padded
   connector rank stride, NaN and +/-inf; times kernel and plain version
   from a CUDA graph, rotating descriptor sets over windows spread across a
   real-size heap, beside its bound, and at the full-width MoE and the ViT
   cells' shapes once more on their whole 4 x 629153792 and 4 x 692316416
   heaps (flat offsets past 2^31); then the same
   for the ``[N, S]``
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
   a. the adversarial-orders workload: ``repro_torch.examples.
      adversarial_orders`` (``run_static_order`` proves the single-FIFO
      baseline deadlocks, then the port's runtime completes it: 3486
      supersteps, 606 preempts);
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
   d. the mesh backend (one device per rank; here a mesh of 8 x ``cuda``,
      each rank's state and scheduler on it, the fused per-ring-group
      exchange, the ranks on side streams of one CUDA graph): the
      reference's own mesh workloads (``tests/test_meshbackend.py``'s
      adversarial orders, two-lane bursts plus a bfloat16 all-gather, and
      chained two-level all-reduces; ``tests/test_daemon_fastpath.py``'s
      packed vs unpacked bfloat16 exchange) with the reference mesh's
      supersteps, preempts and sharded staging flushes (``MESH_REF``),
      then the real-size cell (R=8, slice 1024, K=32, B=8, two 2^20 f32
      all-reduces per rank in opposite orders, one iteration, checked
      against a float64 sum), wall ms per superstep and the elapsed time
      between CUDA events recorded around the drive; then the four
      workloads again on a mesh over two devices, 4 x ``cuda`` + 4 x
      ``cpu`` (run eagerly, every exchange and vote copying between the
      card and the host; the CPU ranks take ``fused_burst``'s plain
      version); every run's outputs bit-equal to the sim backend's on the
      card (its own path, "mesh twin (sim)", run first) with every counter
      equal, and the exchange's permutes per superstep 2 / 2 / 3 / 2 (f32,
      bf16 packed, bf16 unpacked, f16 packed);
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
7. the training and serving paths (main paths, counted like phase 4):
   a. the record's dense grad-sync cell (``BENCH_collectives.json``
      training.dense: qwen3-0.6b reduced, dp 4, 7 buckets, burst 8, skewed
      lanes): the overlapped grads step at 8 ticks per boundary (244
      supersteps, 20 exposed, 224 hidden, 30 tick calls), then at 0
      (barrier: 196, all exposed, 41 tick calls);
   b. the record's MoE cell (training.moe: deepseek-moe-16b reduced, R=4,
      8 tokens per rank, cap 16, 4 streams, 8 overlap ticks): the barrier
      forward (360 supersteps, all exposed, 2 tick calls), bit-equal to the
      port's ``ep_forward_ref``, then the overlapped one (320: 256 exposed,
      64 hidden, 31 tick calls);
   c. the record's serving cell (``serving``, ``benchmarks/bench_serving.py``
      ``REPLAY``): decode p99 52 supersteps, 44 preempts, 780 supersteps
      with preemption; 386.65, 0, 2292 without; the background drains;
   d. grad-sync ``evict(3)`` on 4 ranks: the survivors keep averaging, a
      ``DeviceApi`` kept across it is stale, a fresh one runs a step;
   x. (runs after d, each example a main path of its own, the card
      emptied after each) the port's examples that 4a and g do not run,
      ``repro_torch.examples.<name>.main(["--device", "cuda"])`` at the
      reference's sizes: quickstart, elastic_shrink,
      hierarchical_allreduce, moe_alltoall, overlap_training and
      train_dp_occl (64235008 parameters: its fault-tolerant loop at its
      defaults, 60 steps with a failure before step 40 and checkpoints
      every 25, the first replayed loss bitwise its first run's; its DP
      loop cut to ``EXAMPLE_DP_STEPS``); each one's wall time,
      supersteps, preempts and ``fused_burst`` launches, and its counts
      held to the reference's (``EXAMPLE_COUNTS``; ``auto``'s picks
      follow the card's fit and are printed only);
   e. the full-width MoE cell: DeepSeek-MoE-16B's MoE block (d_model 2048,
      64 experts top-6, 2 shared, d_ff_expert 1408, f32, capacity factor
      1.25) over R=4 expert-parallel ranks, 4096 tokens per rank (cap 480),
      slices of 8192: one barrier forward (bit-equal to ``ep_forward_ref``)
      and one overlapped forward, each within rtol 1e-4 / atol 1e-5 of a
      float64 recomputation from its routing, every exchange completed
      once per rank; supersteps, tick calls, preempts, wall, launches and
      peak memory;
   f. ViT-Base at full width and 1 of its 12 layers (8.6 M parameters;
      the depth cut makes room for k-m and x) over 4 simulated DP ranks,
      global batch 128, DDP-sized buckets (6553600 elements), slice 1024,
      burst 8: one host-driven step of
      ``launch/train.py::run_occl_dp``, then one overlapped grads step at 8
      ticks per boundary and one at 0; each step's OCCL-averaged grads held
      to the float64 average of the per-rank grads (rtol 1e-4, atol 1e-6)
      and every bucket completed once per rank; wall per step, supersteps,
      ``fused_burst`` launches, samples/s and the record's modeled step;
   g. (runs after e) ``repro_torch.examples.serve_batched``: llama3-8b
      ``.reduced()``, 10 requests, batch 4, prompt_len 16: the engine
      alone, then with its ``ServingQos`` fabric with preemption off and
      on (decode p99 258 and 6 supersteps; the background drains), then a
      decode submitted while a background burst holds the lane (4
      preempts); every count held to the reference's, and at least one
      ``fused_burst`` launch per superstep ticked (7h too);
   h. (runs after g, before f; the card is emptied on each side)
      Llama-3-8B at full width and depth (8.03 G parameters, bf16 compute)
      served by ``ServingEngine`` (batch 8, prompt_len 1024, max_len 1080)
      with ``launch/serve.py --qos``'s fabric: 24 seeded requests
      (prompts of 256-1024 tokens, 8-48 new tokens, so slots recycle
      mid-flight); engine build time and peak memory,
      tokens/s, model ms per prefill and per decode step beside the
      decode byte bound and the prefill TFLOP/s, QoS ms per event and its
      digest; token and QoS invariants, every logit finite, and the cache
      check (prefill of 1024 tokens + one decode step against a prefill of
      1025) in bf16 and on the same parameters in float32;
   i. (runs after h, the card emptied on each side) the default training
      path at Qwen3-0.6B's full width (751894528 parameters, batch 8, seq
      64): ``TrainController`` with async checkpoints every 4 steps (keep
      2; 9.02 GB each, in a temporary directory under ``build/``, free
      disk checked first) and a failure injected before step 6, run to
      step 8: one restart, step 4's replayed loss bitwise its first run's,
      step 5's within 1e-5; then ``launch/train.py``'s ``main`` with
      ``--resume --steps 10`` restores a state bit-equal to the
      controller's final one and runs 2 steps; ms per step, seconds per
      save (host copy, write, crc) and per restore, GB written, peak
      memory; then two steps from a fresh state under ``remat="full"``
      and two under ``"dots"`` (ms per step, peak memory; the first
      losses bitwise equal).  The path launches no kernel (asserted);
   n. (runs after i, the card emptied on each side) the sharding layer:
      Qwen3-0.6B's full-width train state laid out under
      ``state_shardings`` on a 4x2 ("data", "model") placement mesh of 8 x
      ``cuda`` positions, saved, and restored onto a 2x2 mesh
      (``restore(..., shardings=)``, the elastic reshard): every gathered
      leaf bit-equal to the state, a device set of 4 for every leaf, s per
      save and per restore, GB written, bytes per position; the plan of
      the state on a 1x1 planning mesh against the growth of
      ``torch.cuda.memory_allocated()`` from ``init_state`` (within 512
      bytes per leaf); and ``python -m repro_torch.launch.dryrun --arch
      llama3-8b --cell decode_32k`` (the 16x16 planning mesh over a fake
      process group, on this machine's CPU, run beside the card work):
      per-device bytes, FLOPs, collectives, plan_s.  Launches no kernel;
   j. Mamba2-2.7B at full width and depth (3.13 G parameters, bf16
      compute) served as in h on the same 24 requests (the counts must
      be h's), its cache check a prefill of 256 tokens + 256 decode steps
      against a prefill of 512 (logits, final state and conv states, in
      bf16 and float32, within ``SSM_CACHE_REL_L2``); then two
      ``make_train_step`` steps at full width (finite losses, peak
      memory);
   k. (runs after j, before f; the card emptied between phases)
      Zamba2-1.2B at full width and depth (1.19 G parameters: 38 Mamba2
      layers and one shared attention + SwiGLU block applied 6 times)
      served as in j, its cache check as j's with the shared block's
      ``shared_k`` / ``shared_v`` compared too (``HYBRID_CACHE_REL_L2``),
      then two ``make_train_step`` steps as in j;
   l. PaliGemma-3B at full width and depth (3.04 G parameters, 256 image
      tokens, prefix-LM attention, GeGLU) served as in h with max_len
      256 + 1024 + 56, so the cache holds image, prompt and new tokens;
      its cache check as h's on seeded random patches (the engine sends
      zero patches, which leave the image positions inert);
   m. SeamlessM4T-large-v2 at full width and depth (2.03 G parameters: a
      24-layer bidirectional encoder over 1024 frames, a 24-layer decoder
      with cross-attention) served as in h, its cache check as l's on
      seeded random frames; the device time of the cross K / V each
      decode step recomputes from the encoder's output;
8. one profiled launch of 32 supersteps each at the flat and the composite
   real-size configs and at the ViT cell's runtime shape (R=4): host wall
   time against device kernel time per superstep, the device's idle share,
   the 15 kernels that take the most device time, the chain relink's
   share; the ``fused_burst`` counter's rise in each launch must equal the
   profiler's count of that kernel.  The profiles run last: a step run in
   the same process after the profiler has run paid more wall per
   superstep;
9. the script's total seconds, the card line again, a
   ``{"kernels": [...]}`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It fails without a CUDA device, and when run outside a checkout of the
repository (the port's sources are not beside it).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
# examples/adversarial_orders.py's runtime (phase 4a runs the port's
# example; phase 2 holds the kernel at its burst shape).
ADV = dict(n_ranks=8, max_colls=8, max_comms=1, slice_elems=64,
           conn_depth=4, heap_elems=1 << 16, superstep_budget=1 << 15)
REAL = dict(n_ranks=8, max_colls=2, max_comms=1, slice_elems=1024,
            conn_depth=32, burst_slices=8, heap_elems=1 << 24)
REAL_BUCKET = 1 << 22
REAL_ITERS = 2
# Phase 4d's real-size mesh cell: the flat cell's shape (R=8, slice 1024,
# K=32, B=8) with buckets of 2^20 (the flat cell's 2^22 cut to fit the
# time limit), one iteration.
MESH_BUCKET = 1 << 20
MESH_CELL = dict(REAL, heap_elems=1 << 22)
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
# The training path: ViT-Base (src/repro_torch/configs/vit_base.py) at full
# width and 1 of its 12 layers (8611584 parameters), 4 simulated DP ranks,
# global batch 128, PyTorch DDP's default bucket (bucket_cap_mb=25 in
# float32), the real-size cells' slice and burst.  Its runtime
# (OcclGradSync's own formula): C=8 (2 buckets), K=24, a heap of 68893696
# elements per rank.  At full depth (9 buckets, a heap of 692308224) the
# cell took 325 s of the script's time limit, at 4 layers 122 s, at 2
# layers 64 s; phase 2 still holds the kernel on the full-depth heap
# (VIT_FULL_RUNTIME).
VIT = dict(arch="vit-base", n_layers=1, dp=4, batch=128,
           bucket_elems=6_553_600, slice_elems=1024, burst_slices=8)
VIT_RUNTIME = dict(R=4, C=8, K=24, heap_elems=68_893_696)
VIT_FULL_RUNTIME = dict(R=4, C=9, K=24, heap_elems=692_308_224)
VIT_HOST_STEPS = 1
VIT_OVERLAP_TICKS = 8
VIT_DRAIN_ITERS = 1 << 15     # drain ticks of 16 supersteps (about 7000 run)
# BENCH_collectives.json "training" -> "dense": qwen3-0.6b reduced, dp 4,
# batch 4, seq 16, 7 buckets, burst 8, 2 bandwidth groups, caps 8 / 2; the
# overlap step (8 ticks per boundary), then the barrier step (0).
DENSE_RECORD = dict(dp=4, batch=4, seq=16, ticks_per_boundary=8,
                    sync=dict(bucket_elems=16384, slice_elems=512,
                              burst_slices=8, bandwidth_groups=2,
                              intra_burst_cap=8, inter_burst_cap=2))
# Its runtime (OcclGradSync's formula): C=8, K=24, heap 867584 per rank.
DENSE_RUNTIME = dict(R=4, C=8, K=24, heap_elems=867_584)
DENSE_STEPS = {
    "overlap": {"supersteps": 244, "exposed_supersteps": 20,
                "hidden_supersteps": 224, "tick_calls": 30},
    "barrier": {"supersteps": 196, "exposed_supersteps": 196,
                "hidden_supersteps": 0, "tick_calls": 41}}

# BENCH_collectives.json "training" -> "moe": deepseek-moe-16b reduced at
# capacity factor 8, R=4 expert-parallel ranks, 8 tokens per rank, cap 16
# (T_l * top_k: no drops), 4 streams, 8 overlap ticks; the barrier forward,
# then the overlapped one.  Its runtime (OcclMoE's formula): C=10, K=8,
# slice 128, heap 81920 per rank.
MOE_RECORD = dict(R=4, tokens=8, cap=16, n_streams=4, overlap_ticks=8,
                  capacity_factor=8.0)
MOE_RUNTIME = dict(R=4, C=10, K=8, slice_elems=128, heap_elems=81_920)
MOE_STEPS = {
    "barrier": {"supersteps": 360, "exposed_supersteps": 360,
                "hidden_supersteps": 0, "tick_calls": 2},
    "overlap": {"supersteps": 320, "exposed_supersteps": 256,
                "hidden_supersteps": 64, "tick_calls": 31}}
# The full-width MoE cell: DeepSeek-MoE-16B's MoE block exactly as
# src/repro_torch/configs/deepseek_moe_16b.py gives it (d_model 2048, 64
# routed experts top-6, 2 shared, d_ff_expert 1408, f32 parameters, its own
# capacity factor 1.25) over R=4 simulated expert-parallel ranks, one
# 4096-token training sequence per rank (cap 480), 4 streams, 8 overlap
# ticks, slices of 8192 f32 (32 KiB).  Tokens: a seeded normal draw plus
# MOE_SHARED times one shared direction, so the router's load is uneven
# and capacity drops real assignments.  Runtime: C=10, K=8, heap
# 10 * 64 * 480 * 2048 = 629145600 elements per rank.
MOE_FULL = dict(arch="deepseek-moe-16b", R=4, tokens=4096, n_streams=4,
                overlap_ticks=8, slice_elems=8192, seed=16)
MOE_FULL_RUNTIME = dict(R=4, C=10, K=8, slice_elems=8192,
                        heap_elems=629_145_600)
MOE_SHARED = 0.15
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5    # against the float64 recomputation
# BENCH_collectives.json "serving", benchmarks/bench_serving.py's REPLAY:
# 12 open-loop requests (Poisson gaps of 24 supersteps), a prefill
# all-gather then 4 chained decode all-reduces each, against a background
# tenant pumped to its admission cap of 2 grad-sync bursts; run with
# preemption on and off.  Its runtime: R=4, C=8, K=4, slice 64, heap 2^17.
SERVING_REPLAY = {
    "seed": 0, "n_ranks": 4, "n_requests": 12, "decode_chain": 4,
    "mean_gap": 24.0, "decode_elems": 256, "prefill_elems": 1024,
    "background_elems": 4096, "background_buckets": 2,
    "max_background_inflight": 2, "prio_aging_quantum": 8,
    "prio_aging_cap": 255, "horizon": 1 << 15}
SERVING_RUNTIME = dict(R=4, C=8, K=4, slice_elems=64, heap_elems=1 << 17)
SERVING_COUNTS = {
    True: {"p99": 52.0, "preempts": 44, "supersteps": 780},
    False: {"p99": 386.65, "preempts": 0, "supersteps": 2292}}


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
    """Return the last phase's device memory: collect its garbage first
    (a runtime's objects hold reference cycles, so its heaps outlive the
    phase until the cyclic collector runs), then empty PyTorch's cache."""
    import torch

    gc.collect()
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
    # The mesh backend: each rank's burst on its own (R = 1).
    ("mesh", 1, 1, MESH_CELL["burst_slices"], MESH_CELL["slice_elems"],
     MESH_CELL["max_colls"], MESH_CELL["conn_depth"],
     MESH_CELL["heap_elems"]),
    *((f"composite {a}", COMP["n_ranks"], lanes, COMP["burst_slices"],
       COMP["slice_elems"], COMP["max_colls"], COMP["conn_depth"],
       COMP["heap_elems"]) for a, lanes in COMP_LANES.items()),
    ("dense record", DENSE_RUNTIME["R"], 1,
     DENSE_RECORD["sync"]["burst_slices"], DENSE_RECORD["sync"]["slice_elems"],
     DENSE_RUNTIME["C"], DENSE_RUNTIME["K"], DENSE_RUNTIME["heap_elems"]),
    ("serving", SERVING_RUNTIME["R"], 1, 1, SERVING_RUNTIME["slice_elems"],
     SERVING_RUNTIME["C"], SERVING_RUNTIME["K"],
     SERVING_RUNTIME["heap_elems"]),
    ("moe record", MOE_RUNTIME["R"], 1, 1, MOE_RUNTIME["slice_elems"],
     MOE_RUNTIME["C"], MOE_RUNTIME["K"], MOE_RUNTIME["heap_elems"]),
    ("moe fullwidth", MOE_FULL_RUNTIME["R"], 1, 1,
     MOE_FULL_RUNTIME["slice_elems"], MOE_FULL_RUNTIME["C"],
     MOE_FULL_RUNTIME["K"], MOE_FULL_RUNTIME["heap_elems"]),
    ("vit", VIT_FULL_RUNTIME["R"], 1, VIT["burst_slices"], VIT["slice_elems"],
     VIT_FULL_RUNTIME["C"], VIT_FULL_RUNTIME["K"],
     VIT_FULL_RUNTIME["heap_elems"]))
# Shapes whose whole real-size heap (flat offsets past 2^31) is also held.
FULL_HEAP_SHAPES = ("moe fullwidth", "vit")
FULL_HEAP_CHECKS = 3           # descriptor sets held on each such heap
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
        if name in FULL_HEAP_SHAPES:
            times[name]["max_abs_err"] = full_heap_check(
                rng, payload, heap_in, heap_out, R, L, B, SL, C, K, H, device)
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
            "max_abs_err": max(errs + [times[n]["max_abs_err"]
                                       for n in FULL_HEAP_SHAPES]),
            "ms": flat["ms"],
            "plain_ms": flat["plain_ms"], "bound_ms": flat["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "by_shape": times}


def full_heap_check(rng, payload, heap_in, heap_out, R, L, B, SL, C, K, H,
                    device) -> float:
    """fused_burst against fused_burst_plain on a cell's whole heap (R x H
    elements: flat offsets past 2^31, so every row base must be 64-bit),
    windows spread over the row; compared rank by rank."""
    import torch
    from repro_torch.kernels import fused_slice as fs

    err = 0.0
    for _ in range(FULL_HEAP_CHECKS):
        args = burst_args(*burst_descriptors(rng, R, L, B, SL, C, K, H,
                                             False), device)
        h_k = heap_out.clone()
        got = fs.fused_burst(payload, heap_in, h_k, B, *args)
        torch.cuda.synchronize()
        h_p = heap_out.clone()
        want = fs.fused_burst_plain(payload, heap_in, h_p, B, *args)
        err = max(err, compare_bits(got, want))
        for r in range(R):
            assert bits_equal(h_k[r], h_p[r]), ("heap_out", r)
        del h_k, h_p
        free_card()
    print(f"[kernels] fused_burst R={R} SL={SL}: outbox and heap_out "
          f"bitwise equal to plain on the whole {R} x {H} heap ({R * H} "
          f"elements) in {FULL_HEAP_CHECKS} cases")
    return err


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
    """``repro_torch.examples.adversarial_orders`` on the card: the static
    baseline deadlocks, the port's runtime completes the workload."""
    from repro_torch.examples import adversarial_orders

    res = adversarial_orders.main(["--device", str(device)])
    assert res["static"]["deadlocked"] and res["static"]["cycle"], res
    print(f"[adversarial] static single-FIFO execution deadlocks; wait-for "
          f"cycle over ranks {res['static']['cycle']}")
    print(f"[adversarial] OCCL completed {res['completed']} all-reduces "
          f"correctly in {res['supersteps']} supersteps, {res['preempts']} "
          f"preempts, {res['launches']} launches, {res['seconds']:.3f} s")
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
# phase 4d: the mesh backend (one device per rank)
# ---------------------------------------------------------------------------
#
# The reference's own mesh workloads (tests/test_meshbackend.py,
# tests/test_daemon_fastpath.py), each a function of ``(core, make_rt)``:
# ``make_rt(cfg_kwargs)`` builds a runtime of ``core`` (the port's on a
# mesh or on the sim backend, or the reference's on its shard_map mesh),
# and the function returns ``({tag: runtime}, {key: output})`` after
# checking the outputs as the reference's test does.

def mesh_adversarial(core, make_rt):
    """tests/test_meshbackend.py: three collectives on two rings, in
    adversarial per-rank orders."""
    rt = make_rt(dict(n_ranks=8, max_colls=8, max_comms=2, slice_elems=8,
                      conn_depth=3, heap_elems=1 << 13))
    world = rt.communicator(list(range(8)))
    evens = rt.communicator([0, 2, 4, 6])
    a = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=96)
    b = rt.register(core.CollKind.REDUCE_SCATTER, world, n_elems=64)
    c = rt.register(core.CollKind.ALL_REDUCE, evens, n_elems=24)
    rng = np.random.RandomState(0)
    xa = [rng.randn(96).astype(np.float32) for _ in range(8)]
    xb = [rng.randn(64).astype(np.float32) for _ in range(8)]
    xc = {r: rng.randn(24).astype(np.float32) for r in evens.members}
    for r in range(8):
        rt.write_input(r, a, xa[r])
        rt.write_input(r, b, xb[r])
        order = [a, b] if r % 2 == 0 else [b, a]
        if r in evens.members:
            rt.write_input(r, c, xc[r])
            order.insert(r % 3 % 2, c)
        for cid in order:
            rt.submit(r, cid)
    rt.drive()
    outs = {}
    for r in range(8):
        outs[(r, a)] = rt.read_output(r, a)
        outs[(r, b)] = rt.read_output(r, b)
        np.testing.assert_allclose(outs[(r, a)], sum(xa), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(outs[(r, b)], sum(xb)[r * 8:(r + 1) * 8],
                                   rtol=1e-4, atol=1e-6)
    for r in evens.members:
        outs[(r, c)] = rt.read_output(r, c)
        np.testing.assert_allclose(outs[(r, c)], sum(xc.values()),
                                   rtol=1e-4, atol=1e-6)
    return {"adversarial": rt}, outs


def mesh_burst(core, make_rt):
    """tests/test_meshbackend.py: bursts of 4 slices on two lanes (f32),
    then an all-gather on a bfloat16 heap (the packed exchange) whose
    all-ranks staged submits take the sharded flush on a mesh."""
    rt = make_rt(dict(n_ranks=8, max_colls=8, max_comms=2, slice_elems=8,
                      conn_depth=8, burst_slices=4, heap_elems=1 << 13))
    world = rt.communicator(list(range(8)))
    evens = rt.communicator([0, 2, 4, 6])
    a = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=96)
    c = rt.register(core.CollKind.ALL_GATHER, evens, n_elems=32)
    rng = np.random.RandomState(0)
    xa = [rng.randn(96).astype(np.float32) for _ in range(8)]
    xc = {r: rng.randn(8).astype(np.float32) for r in evens.members}
    for r in range(8):
        rt.write_input(r, a, xa[r])
        if r in evens.members:
            rt.write_input(r, c, xc[r])
            rt.submit(r, c)
        rt.submit(r, a)
    rt.drive()
    outs = {}
    want = np.concatenate([xc[r] for r in evens.members])
    for r in range(8):
        outs[("f32", r, a)] = rt.read_output(r, a)
        np.testing.assert_allclose(outs[("f32", r, a)], sum(xa), rtol=1e-4,
                                   atol=1e-6)
    for r in evens.members:
        outs[("f32", r, c)] = rt.read_output(r, c)
        np.testing.assert_allclose(outs[("f32", r, c)], want, rtol=1e-4,
                                   atol=1e-6)
    rt16 = make_rt(dict(n_ranks=8, max_colls=2, max_comms=1, slice_elems=8,
                        conn_depth=6, burst_slices=4, dtype="bfloat16",
                        heap_elems=1 << 12))
    world16 = rt16.communicator(list(range(8)))
    g = rt16.register(core.CollKind.ALL_GATHER, world16, n_elems=64)
    xg = [rng.randn(8).astype(np.float32) for _ in range(8)]
    for r in range(8):
        rt16.submit(r, g, data=xg[r])
    rt16.drive()
    wg = np.concatenate(xg)
    for r in range(8):
        outs[("bf16", r, g)] = np.asarray(rt16.read_output(r, g), np.float32)
        np.testing.assert_allclose(outs[("bf16", r, g)], wg, rtol=2e-2,
                                   atol=2e-2)
    return {"f32": rt, "bf16": rt16}, outs


def mesh_packed(core, make_rt):
    """tests/test_daemon_fastpath.py: a bfloat16 all-reduce and all-gather
    in opposite orders, over the packed and the unpacked exchange; the two
    give the same bits."""
    rts, outs = {}, {}
    for packed in (False, True):
        rt = make_rt(dict(n_ranks=8, max_colls=4, max_comms=1, slice_elems=8,
                          conn_depth=12, burst_slices=4, dtype="bfloat16",
                          heap_elems=1 << 13, packed_16bit=packed))
        world = rt.communicator(list(range(8)))
        a = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=96)
        g = rt.register(core.CollKind.ALL_GATHER, world, n_elems=64)
        rng = np.random.RandomState(0)
        xa = [rng.randn(96).astype(np.float32) for _ in range(8)]
        xg = [rng.randn(8).astype(np.float32) for _ in range(8)]
        for r in range(8):
            for cid in ([a, g] if r % 2 == 0 else [g, a]):
                rt.submit(r, cid, data=(xa[r] if cid == a else xg[r]))
        rt.drive()
        tag = "packed" if packed else "unpacked"
        rts[tag] = rt
        for r in range(8):
            for cid in (a, g):
                outs[(tag, r, cid)] = np.asarray(rt.read_output(r, cid),
                                                 np.float32)
    for key, v in outs.items():
        if key[0] == "packed":
            assert v.tobytes() == outs[("unpacked",) + key[1:]].tobytes(), key
    return rts, outs


def mesh_chained(core, make_rt):
    """tests/test_meshbackend.py: two two-level all-reduce chains on the
    derived intra / inter lanes, submitted in conflicting orders."""
    rt = make_rt(dict(n_ranks=8, max_colls=8, max_comms=3, slice_elems=8,
                      conn_depth=4, heap_elems=1 << 13,
                      superstep_budget=1 << 14))
    world = rt.communicator(list(range(8)))
    a = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=96,
                    algo="two_level", hierarchy=(2, 4))
    b = rt.register(core.CollKind.ALL_REDUCE, world, n_elems=56,
                    algo="two_level", hierarchy=(2, 4))
    rng = np.random.RandomState(0)
    xa = [rng.randn(96).astype(np.float32) for _ in range(8)]
    xb = [rng.randn(56).astype(np.float32) for _ in range(8)]
    for r in range(8):
        order = [(a, xa), (b, xb)] if r % 2 == 0 else [(b, xb), (a, xa)]
        for cid, xs in order:
            rt.submit(r, cid, data=xs[r])
    rt.drive(max_launches=128)
    outs = {}
    for r in range(8):
        outs[(r, a)] = rt.read_output(r, a)
        outs[(r, b)] = rt.read_output(r, b)
        np.testing.assert_allclose(outs[(r, a)], sum(xa), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(outs[(r, b)], sum(xb), rtol=1e-4,
                                   atol=1e-5)
    st = rt.stats()
    chain = st["chains"][a]
    assert (st["stage_completions"][:, chain] >= 1).all(), st["chains"]
    assert (st["completed"][:, chain[-1]] == 1).all()
    return {"chained": rt}, outs


# The exchange's permutes per superstep (R=8, B=4, slice 64), as
# BENCH_collectives.json "mesh" "ppermutes_per_superstep" records them.
MESH_PERMUTE_CFGS = {"float32": ("float32", True),
                     "bfloat16 packed": ("bfloat16", True),
                     "bfloat16 unpacked": ("bfloat16", False),
                     "float16 packed": ("float16", True)}
MESH_PERMUTES = {"float32": 2, "bfloat16 packed": 2, "bfloat16 unpacked": 3,
                 "float16 packed": 2}
MESH_WORKLOADS = {"adversarial": mesh_adversarial, "burst": mesh_burst,
                  "packed": mesh_packed, "chained": mesh_chained}
# Counters held equal between the port's mesh, its sim and the reference's
# mesh (the staging flush counts included).
MESH_COUNTERS = ("supersteps", "preempts", "stall_slices",
                 "stage_completions", "completed", "slices_moved",
                 "rtc_events", "cq_count", "staging_sharded_flushes")
# The reference's mesh on these workloads, per runtime: (supersteps,
# preempts, staging_sharded_flushes), from its shard_map daemon on 8 XLA
# CPU devices (tests/test_torch_mesh.py holds the port to that run).
MESH_REF = {"adversarial": {"adversarial": (60, 4, 0)},
            "burst": {"f32": (19, 0, 0), "bf16": (8, 0, 1)},
            "packed": {"unpacked": (35, 4, 1), "packed": (35, 4, 1)},
            "chained": {"chained": (63, 4, 0)}}


def mesh_counts(rts: dict) -> dict:
    """{tag: {counter: array or int}} of a workload's runtimes."""
    out = {}
    for tag, rt in rts.items():
        st = rt.stats()
        out[tag] = {k: np.asarray(st[k]) for k in MESH_COUNTERS}
    return out


def mesh_summary(counts: dict) -> dict:
    """{tag: (supersteps, preempts, sharded flushes)}."""
    return {tag: (int(c["supersteps"].max()), int(c["preempts"].sum()),
                  int(c["staging_sharded_flushes"]))
            for tag, c in counts.items()}


def mesh_maker(core, device, mesh=None):
    """``make_rt`` for the port: the mesh backend over ``mesh`` (one device
    per rank), or with none the sim backend on ``device``."""
    def make(kw):
        cfg = core.OcclConfig(**kw)
        if mesh is not None:
            return core.OcclRuntime(cfg, mesh=mesh)
        return core.OcclRuntime(cfg, device=device)
    return make


def mesh_real(core, make_rt, card: str, tag: str) -> dict:
    """The real-size cell: two MESH_BUCKET all-reduces per rank in opposite
    orders on odd and even ranks, one iteration; wall ms per superstep and
    the elapsed ms per superstep between CUDA events recorded around the
    drive (host-synchronised on both sides, so it tracks the wall time and
    says nothing of how busy the card is), the outputs, counts."""
    import torch

    R = MESH_CELL["n_ranks"]
    rt = make_rt(MESH_CELL)
    world = rt.communicator(list(range(R)))
    ids = [rt.register(core.CollKind.ALL_REDUCE, world, n_elems=MESH_BUCKET)
           for _ in range(2)]
    rng = np.random.default_rng(2020)
    xs = [rng.standard_normal((R, MESH_BUCKET), dtype=np.float32)
          for _ in ids]
    for r in range(R):
        for b in ([0, 1] if r % 2 == 0 else [1, 0]):
            rt.submit(r, ids[b], data=xs[b][r])
    cuda = torch.cuda.is_available() and rt.device.type == "cuda"
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
    t0 = time.perf_counter()
    rt.drive()
    if cuda:
        end.record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    event_ms = start.elapsed_time(end) if cuda else float("nan")
    for b, cid in enumerate(ids):
        check_sum(rt, cid, xs[b], R)
    outs = rt.read_outputs_bulk([(r, cid) for cid in ids for r in range(R)])
    st = rt.stats()
    steps = int(st["supersteps"].max())
    res = {"supersteps": steps, "preempts": int(st["preempts"].sum()),
           "wall_s": wall, "wall_ms_per_superstep": wall * 1e3 / steps,
           "event_ms_per_superstep": event_ms / steps,
           "launches": rt.launches,
           "counts": mesh_counts({"real": rt}), "outputs": outs}
    print(f"[mesh] real size on the {tag}: R={R}, 2 x {MESH_BUCKET} f32 "
          f"per rank, {steps} supersteps, {res['preempts']} preempts, "
          f"{wall:.3f} s wall, {res['wall_ms_per_superstep']:.4f} ms wall "
          f"and {res['event_ms_per_superstep']:.4f} ms between CUDA events "
          f"around the drive per superstep [{card}]")
    return res


def mesh_runs(device, card: str, mesh=None, real: bool = True) -> dict:
    """Phase 4d's runs on one backend (the mesh over ``mesh``, else the
    sim on ``device``): the four workloads and, with ``real``, the
    real-size cell."""
    from repro_torch import core

    devs = sorted({str(d) for d in mesh or ()})
    tag = f"mesh over {devs}" if mesh is not None else "sim"
    make = mesh_maker(core, device, mesh)
    res = {}
    for name, fn in MESH_WORKLOADS.items():
        t0 = time.perf_counter()
        rts, outs = fn(core, make)
        if mesh is not None:
            # One card: one CUDA graph per chunk; several devices: eager.
            multi = len(devs) > 1
            graphed = devs == ["cuda"]
            assert all(rt._ticker.multi == multi
                       and rt._ticker.graphed == graphed
                       for rt in rts.values()), name
        res[name] = {"counts": mesh_counts(rts), "outputs": outs}
        print(f"[mesh] {name} on the {tag}: (supersteps, preempts, sharded "
              f"flushes) {mesh_summary(res[name]['counts'])}; outputs "
              f"checked; {time.perf_counter() - t0:.2f} s [{card}]")
        del rts
    if real:
        res["real"] = mesh_real(core, make, card, tag)
    free_card()
    return res


def check_mesh(sim: dict, mesh: dict) -> dict:
    """The mesh's runs (every one it made) bit-equal to the sim's, with
    equal counters (the sharded flushes apart: the sim has none), and the
    workloads' counts the reference's mesh's; then the exchange's permute
    counts."""
    from repro_torch.core.daemon import count_exchange_ppermutes
    from repro_torch.core import OcclConfig

    for name in mesh:
        m, s = mesh[name], sim[name]
        assert m["outputs"].keys() == s["outputs"].keys(), name
        for k, v in m["outputs"].items():
            assert (np.asarray(v, np.float32).tobytes()
                    == np.asarray(s["outputs"][k], np.float32).tobytes()), (
                name, k)
        for tag, c in m["counts"].items():
            for k in MESH_COUNTERS[:-1]:
                assert np.array_equal(c[k], s["counts"][tag][k]), (
                    name, tag, k)
            assert int(s["counts"][tag]["staging_sharded_flushes"]) == 0
        if name != "real":
            assert mesh_summary(m["counts"]) == MESH_REF[name], (
                name, mesh_summary(m["counts"]), MESH_REF[name])
    perm = {label: count_exchange_ppermutes(OcclConfig(
                n_ranks=8, max_comms=1, slice_elems=64, burst_slices=4,
                dtype=dt, packed_16bit=packed))
            for label, (dt, packed) in MESH_PERMUTE_CFGS.items()}
    assert perm == MESH_PERMUTES, perm
    print(f"[mesh] outputs bit-equal to the sim and every counter equal on "
          f"{list(mesh)}; workload counts equal the reference mesh's "
          f"{MESH_REF}; permutes per superstep {perm}")
    return perm


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
# phase 7: the training path: the record's dense grad-sync cell and ViT-Base
# ---------------------------------------------------------------------------

def step_counts(s0: dict, s1: dict) -> dict:
    """A step's supersteps split into exposed (barrier) and hidden
    (overlap) ones, and its tick calls (lockstep sim: max over ranks)."""
    d = lambda k: int(np.max(s1[k] - s0[k]))
    return {"supersteps": d("supersteps"),
            "exposed_supersteps": d("barrier_supersteps"),
            "hidden_supersteps": d("overlap_supersteps"),
            "tick_calls": d("tick_calls")}


def dense_record(device) -> dict:
    """``BENCH_collectives.json`` training.dense on the port: the
    overlapped grads step at 8 ticks per boundary, then the same step at 0
    (barrier), on one sync; returns each step's counts and mean loss."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_overlap_grads_step

    c = DENSE_RECORD
    cfg = get_config("qwen3-0.6b").reduced()
    cell = ShapeCell("dense", c["seq"], c["batch"], "train")
    dp = c["dp"]
    params = [init_state(cfg, device=device).params for _ in range(dp)]
    batches = [SyntheticPipeline(cfg, cell, shard_id=r,
                                 n_shards=dp).batch_at(0) for r in range(dp)]
    sync = OcclGradSync(init_state(cfg, device="meta").params, dp,
                        device=device, **c["sync"])
    rc = sync.occl.cfg
    assert (rc.n_ranks, rc.max_colls, rc.conn_depth, rc.heap_elems) \
        == tuple(DENSE_RUNTIME.values()), rc
    out = {"buckets": len(sync.buckets)}
    for mode, k in (("overlap", c["ticks_per_boundary"]), ("barrier", 0)):
        step = make_overlap_grads_step(cfg, sync, ticks_per_boundary=k)
        s0 = sync.stats()
        st, losses, _ = step(sync.occl.state, params, batches)
        sync.occl.adopt_state(st)
        out[mode] = dict(step_counts(s0, sync.stats()),
                         loss_mean=float(losses.mean()))
    return out


def phase_train_record(device) -> dict:
    res = dense_record(device)
    for mode in ("overlap", "barrier"):
        r = res[mode]
        print(f"[train record] dense grad sync, {mode}: {r['supersteps']} "
              f"supersteps, {r['exposed_supersteps']} exposed, "
              f"{r['hidden_supersteps']} hidden, {r['tick_calls']} tick "
              f"calls, loss {r['loss_mean']:.6f}")
        got = {k: r[k] for k in DENSE_STEPS[mode]}
        assert got == DENSE_STEPS[mode], (mode, got)
    return res


# ---------------------------------------------------------------------------
# phase 7b, 7e: expert-parallel MoE over OCCL (the record's cell, full width)
# ---------------------------------------------------------------------------

def moe_counts(moe, fn, params, xs) -> tuple:
    """One forward's outputs and counts (step_counts plus preempts)."""
    s0 = moe.stats()
    ys = fn(params, xs)
    s1 = moe.stats()
    return ys, dict(step_counts(s0, s1), preempts=int(
        (s1["preempts"] - s0["preempts"]).sum()))


def moe_record(device) -> dict:
    """``BENCH_collectives.json`` training.moe on the port: the barrier
    forward, then the overlapped one, on one ``OcclMoE``; returns each
    forward's counts, whether the barrier output is bit-equal to the port's
    ``ep_forward_ref`` and the overlapped output's largest difference from
    it."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe_block
    from repro_torch.train.occl_moe import OcclMoE, ep_forward_ref

    c = MOE_RECORD
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              capacity_factor=c["capacity_factor"])
    params = init_moe_block(0, "t", cfg, torch.float32, device)
    rng = np.random.RandomState(2)
    xs = [torch.from_numpy((rng.randn(c["tokens"], cfg.d_model) * 0.5)
                           .astype(np.float32)).to(device)
          for _ in range(c["R"])]
    moe = OcclMoE(cfg, c["R"], c["tokens"], cap=c["cap"],
                  n_streams=c["n_streams"], overlap_ticks=c["overlap_ticks"],
                  device=device)
    rc = moe.occl.cfg
    assert (rc.n_ranks, rc.max_colls, rc.conn_depth, rc.slice_elems,
            rc.heap_elems) == tuple(MOE_RUNTIME.values()), rc
    ref = ep_forward_ref(cfg, params, xs, cap=c["cap"])
    out = {}
    yb, out["barrier"] = moe_counts(moe, moe.forward, params, xs)
    yo, out["overlap"] = moe_counts(moe, moe.forward_overlapped, params, xs)
    out["barrier_bitwise"] = all(bits_equal(a, b) for a, b in zip(yb, ref))
    out["overlap_max_abs_diff"] = max(float((a - b).abs().max())
                                      for a, b in zip(yo, ref))
    out["overlap_close"] = all(bool(torch.allclose(a, b, rtol=1e-5,
                                                   atol=1e-9))
                               for a, b in zip(yo, ref))
    return out


def phase_moe_record(device) -> dict:
    res = moe_record(device)
    for mode in ("barrier", "overlap"):
        r = res[mode]
        print(f"[moe record] {mode} forward: {r['supersteps']} supersteps, "
              f"{r['exposed_supersteps']} exposed, {r['hidden_supersteps']} "
              f"hidden, {r['tick_calls']} tick calls, {r['preempts']} "
              f"preempts")
        got = {k: r[k] for k in MOE_STEPS[mode]}
        assert got == MOE_STEPS[mode], (mode, got)
    print(f"[moe record] barrier output bitwise equal to ep_forward_ref: "
          f"{res['barrier_bitwise']}; overlapped output within "
          f"{res['overlap_max_abs_diff']:.3g} of it (rtol 1e-5, atol 1e-9)")
    assert res["barrier_bitwise"] and res["overlap_close"], res
    return res


def moe_tokens(cfg, R: int, tokens: int, seed: int, device) -> list:
    """R seeded [tokens, D] float32 token matrices: a normal draw plus
    ``MOE_SHARED`` times one shared direction (uneven expert load)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((R, tokens, cfg.d_model), generator=g, device=device)
    shared = torch.randn((cfg.d_model,), generator=g, device=device)
    return list(x + MOE_SHARED * shared)


def moe_float64_err(cfg, params, x, y, tok_idx, w, slots) -> float:
    """Largest |y - y64| over one rank, where y64 is the expert FFN, the
    weighted combine (same slots and weights) and the shared experts
    recomputed in float64; raises beyond MOE_RTOL / MOE_ATOL."""
    import torch
    import torch.nn.functional as F

    E, cap, D = w.shape[0], w.shape[1], cfg.d_model
    valid = torch.zeros(E * cap + 1, dtype=torch.bool, device=x.device)
    valid[slots.reshape(-1)] = True
    valid = valid[:-1].view(E, cap)
    x64 = x.double()
    xe = torch.where(valid[..., None], x64[tok_idx], 0.0)
    h = torch.einsum("ecd,edf->ecf", xe, params["wg"].double())
    u = torch.einsum("ecd,edf->ecf", xe, params["wu"].double())
    ye = torch.einsum("ecf,efd->ecd", F.silu(h) * u, params["wd"].double())
    del xe, h, u
    contrib = (ye * (w.double() * valid)[..., None]).reshape(-1, D)
    y64 = torch.zeros((x.shape[0], D), dtype=torch.float64,
                      device=x.device).index_add_(0, tok_idx.reshape(-1),
                                                  contrib)
    if "shared_wg" in params:
        hs = F.silu(x64 @ params["shared_wg"].double()) * (
            x64 @ params["shared_wu"].double())
        y64 = y64 + hs @ params["shared_wd"].double()
    diff = (y.double() - y64).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((diff <= MOE_ATOL + MOE_RTOL * y64.abs()).all()), float(
        diff.max())
    return float(diff.max())


def moe_fullwidth(device, cfg, tokens: int, slice_elems: int,
                  seed: int) -> dict:
    """One barrier ``forward`` and one ``forward_overlapped`` of
    ``OcclMoE`` on ``cfg``'s MoE block over R=4 expert-parallel ranks:
    each checked against the float64 recomputation from its own routing,
    every exchange completed once per rank; the barrier output bit for bit
    against the port's ``ep_forward_ref``.  Returns counts, wall, launches
    and the errors."""
    import torch
    from repro_torch.kernels import fused_slice as fs
    from repro_torch.models.moe import init_moe_block
    from repro_torch.train.occl_moe import (OcclMoE, _dispatch_local_t,
                                            ep_forward_ref)

    c = MOE_FULL
    R = c["R"]
    params = init_moe_block(seed, "l0/moe", cfg, torch.float32, device)
    xs = moe_tokens(cfg, R, tokens, seed, device)
    moe = OcclMoE(cfg, R, tokens, slice_elems=slice_elems,
                  n_streams=c["n_streams"], overlap_ticks=c["overlap_ticks"],
                  device=device)
    _sync(device)
    t0 = time.perf_counter()
    moe.occl.state          # the first touch builds tables and heaps
    _sync(device)
    build_s = time.perf_counter() - t0
    cap = moe.cap
    routing = [_dispatch_local_t(cfg, params, x, cap)[1:] for x in xs]
    kept = sum(int((s < cfg.n_experts * cap).sum()) for _, _, s in routing)
    res = {"cap": cap, "n_elems": moe.n_elems, "build_s": build_s,
           "dropped_share": 1.0 - kept / (R * tokens * cfg.top_k),
           "runtime": moe.occl.cfg}
    ref = ep_forward_ref(cfg, params, xs, cap=cap)
    ids = {"barrier": [moe.disp_id, moe.comb_id],
           "overlap": moe.disp_stream_ids + moe.comb_stream_ids}
    for mode, fn in (("barrier", moe.forward),
                     ("overlap", moe.forward_overlapped)):
        c0 = moe.stats()["completed"]
        n0 = fs.fused_burst.launches
        spent = split_calls(moe.occl, BARRIER_SPLIT, device) \
            if mode == "barrier" else None
        _sync(device)
        t0 = time.perf_counter()
        ys, rec = moe_counts(moe, fn, params, xs)
        _sync(device)
        rec["wall_s"] = time.perf_counter() - t0
        if spent is not None:
            for name in BARRIER_SPLIT:
                delattr(moe.occl, name)
            rec["split_s"] = {
                "daemon": spent["drive"] - spent["_flush_staged"],
                "flush": spent["_flush_staged"],
                "read": spent["read_outputs_bulk"],
                "rest": rec["wall_s"] - spent["drive"]
                - spent["read_outputs_bulk"]}
        rec["fused_burst_launches"] = fs.fused_burst.launches - n0
        c1 = moe.stats()["completed"]
        assert (c1[:, ids[mode]] - c0[:, ids[mode]] == 1).all(), (
            mode, c1 - c0)
        rec["float64_max_abs_err"] = max(
            moe_float64_err(cfg, params, x, y, *rt)
            for x, y, rt in zip(xs, ys, routing))
        if mode == "barrier":
            rec["bitwise_vs_ep_ref"] = all(
                bits_equal(a, b) for a, b in zip(ys, ref))
            assert rec["bitwise_vs_ep_ref"], mode
        res[mode] = rec
        del ys
    return res


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# The barrier forward's calls into its runtime, timed one by one.
BARRIER_SPLIT = ("_flush_staged", "drive", "read_outputs_bulk")


def split_calls(obj, names, device) -> dict:
    """Shadow ``obj``'s methods ``names`` with instance attributes that add
    each call's host-clock seconds (ended by a device sync) to the returned
    dict; ``delattr(obj, name)`` restores the method."""
    spent = dict.fromkeys(names, 0.0)
    for name in names:
        def timed(*a, _fn=getattr(obj, name), _name=name, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            _sync(device)
            spent[_name] += time.perf_counter() - t0
            return out
        setattr(obj, name, timed)
    return spent


def phase_moe_fullwidth(device, card: str) -> dict:
    import torch
    from repro_torch.configs import get_config

    c = MOE_FULL
    cfg = get_config(c["arch"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = moe_fullwidth(device, cfg, c["tokens"], c["slice_elems"],
                        c["seed"])
    res["phase_s"] = time.perf_counter() - t0
    rc = res.pop("runtime")
    assert (rc.n_ranks, rc.max_colls, rc.conn_depth, rc.slice_elems,
            rc.heap_elems) == tuple(MOE_FULL_RUNTIME.values()), rc
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[moe fullwidth] {c['arch']} MoE block (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, "
          f"{cfg.n_shared_experts} shared, d_ff_expert {cfg.d_ff_expert}), "
          f"R={c['R']}, {c['tokens']} tokens per rank, cap {res['cap']}, "
          f"{res['n_elems']} elements per exchange per rank, "
          f"{res['dropped_share']:.4f} of the assignments dropped by "
          f"capacity; runtime built (tables, heaps) in "
          f"{res['build_s']:.3f} s [{card}]")
    for mode in ("barrier", "overlap"):
        r = res[mode]
        print(f"[moe fullwidth] {mode} forward: {r['wall_s']:.3f} s wall, "
              f"{r['supersteps']} supersteps ({r['exposed_supersteps']} "
              f"exposed, {r['hidden_supersteps']} hidden), "
              f"{r['tick_calls']} tick calls, {r['preempts']} preempts, "
              f"{r['wall_s'] * 1e3 / r['supersteps']:.4f} ms per "
              f"superstep, {r['fused_burst_launches']} fused_burst "
              f"launches, within {r['float64_max_abs_err']:.3g} of the "
              f"float64 recomputation [{card}]")
    sp = res["barrier"]["split_s"]
    print(f"[moe fullwidth] barrier forward on the host clock: daemon "
          f"{sp['daemon']:.3f} s "
          f"({sp['daemon'] * 1e3 / res['barrier']['supersteps']:.4f} ms per "
          f"superstep), staging flushes {sp['flush']:.3f} s, output reads "
          f"{sp['read']:.3f} s, the rest (dispatch, expert FFN, combine, "
          f"host copies) {sp['rest']:.3f} s [{card}]")
    print(f"[moe fullwidth] barrier output bitwise equal to ep_forward_ref:"
          f" {res['barrier']['bitwise_vs_ep_ref']}; every exchange "
          f"completed once per rank; peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; phase "
          f"{res['phase_s']:.1f} s [{card}]")
    print("[moe fullwidth] summary " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 7c: the serving QoS replay (BENCH_collectives.json "serving")
# ---------------------------------------------------------------------------

def serving_replay(preemption: bool, device, spec: dict = SERVING_REPLAY
                   ) -> dict:
    """``benchmarks/bench_serving.py``'s ``replay`` on the port: the same
    traffic trace (from ``spec['seed']`` alone) through ``ServingQos``;
    returns decode latencies (supersteps), the fabric's counts and the
    background tenant's drain."""
    from repro_torch.serving.qos import ServingQos, TrafficClass

    qos = ServingQos(
        n_ranks=spec["n_ranks"], decode_elems=spec["decode_elems"],
        prefill_elems=spec["prefill_elems"],
        background_elems=spec["background_elems"],
        background_buckets=spec["background_buckets"],
        max_background_inflight=spec["max_background_inflight"],
        preemption=preemption,
        prio_aging_quantum=spec["prio_aging_quantum"],
        prio_aging_cap=spec["prio_aging_cap"], tick_chunk=1, device=device)
    rng = np.random.RandomState(spec["seed"])
    arrivals = np.cumsum(
        rng.exponential(spec["mean_gap"], spec["n_requests"])).astype(int)
    jobs = [{"arrival": int(a), "rec": None, "prefilled": False,
             "left": spec["decode_chain"], "done_at": None}
            for a in arrivals]
    decode_lat = []
    qos.pump_background()
    t0 = time.perf_counter()
    while any(j["done_at"] is None for j in jobs):
        if qos.now > spec["horizon"]:
            raise RuntimeError(
                f"serving replay exceeded its {spec['horizon']}-superstep "
                f"horizon (preemption={preemption})")
        for j in jobs:
            if j["done_at"] is not None or j["arrival"] > qos.now:
                continue
            if j["rec"] is None:
                j["rec"] = qos.submit_prefill()
            elif j["rec"]["done_at"] is not None:
                if j["prefilled"]:
                    decode_lat.append(
                        j["rec"]["done_at"] - j["rec"]["arrival"])
                    j["left"] -= 1
                else:
                    j["prefilled"] = True
                if j["left"] == 0:
                    j["done_at"] = qos.now
                else:
                    j["rec"] = qos.submit_decode()
        qos.pump_background()
        qos.advance()
    busy_wall = time.perf_counter() - t0
    busy = max(qos.now, 1)
    bg = qos.tenants[TrafficClass.BACKGROUND]
    drain = qos.drain()
    s = qos.summary()
    lat = np.asarray(decode_lat, float)
    return {"decode_latencies": decode_lat,
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)),
            "prefill_p99": s["prefill"]["p99"],
            "supersteps": s["supersteps"], "preempts": s["preempts"],
            "background_completed": bg.completed,
            "background_drained": bg.completed == bg.submitted,
            "drain_supersteps": int(drain), "busy_supersteps": busy,
            "busy_wall_s": busy_wall, "superstep_s": busy_wall / busy}


def phase_serving(device, card: str) -> dict:
    out = {}
    for pre in (True, False):
        r = serving_replay(pre, device)
        out["preempt_on" if pre else "preempt_off"] = r
        print(f"[serving] preemption {'on' if pre else 'off'}: decode p50 "
              f"{r['p50']:g} / p99 {r['p99']:g} supersteps over "
              f"{len(r['decode_latencies'])} decode steps, {r['preempts']} "
              f"preempts, {r['supersteps']} supersteps, background drained "
              f"{r['background_drained']} in {r['drain_supersteps']}; "
              f"{r['busy_wall_s']:.3f} s for {r['busy_supersteps']} busy "
              f"supersteps ({r['superstep_s'] * 1e3:.4f} ms each, host "
              f"loop included) [{card}]")
        got = {k: r[k] for k in SERVING_COUNTS[pre]}
        assert got == SERVING_COUNTS[pre], (pre, got)
        assert r["background_drained"], r
    return out


# ---------------------------------------------------------------------------
# phase 7d: grad-sync evict and DeviceApi staleness on the card
# ---------------------------------------------------------------------------

# A small gradient tree (two buckets of at most 4096 elements) on 4 DP
# ranks.
EVICT_SYNC = dict(dp=4, bucket_elems=4096,
                  shapes={"attn_wo": (64, 32), "attn_wq": (32, 64),
                          "mlp_b": (300,), "mlp_w": (48, 40)})


def grad_sync_evict(device) -> dict:
    """``OcclGradSync.evict(3)`` on a 4-rank sync: the 3 survivors'
    buckets keep averaging (float64 average, rtol 1e-5, atol 1e-6); a
    ``DeviceApi`` kept across the evict is stale and refuses a step, a
    fresh one runs a step of every bucket."""
    import torch
    from repro_torch.core.errors import EvictionError
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.tree import tree_leaves, tree_unflatten

    c = EVICT_SYNC
    template = {k: torch.empty(s, device="meta")
                for k, s in c["shapes"].items()}
    sync = OcclGradSync(template, c["dp"], bucket_elems=c["bucket_elems"],
                        device=device)
    rng = np.random.RandomState(7)
    shapes = [tuple(l.shape) for l in tree_leaves(template)]

    def grads(n):
        return [[rng.randn(*s).astype(np.float32) for s in shapes]
                for _ in range(n)]

    def check(flat, got) -> float:
        err = 0.0
        for r, tree in enumerate(got):
            for i, a in enumerate(tree_leaves(tree)):
                want = np.mean([f[i].astype(np.float64) for f in flat], 0)
                np.testing.assert_allclose(a.cpu().numpy(), want, rtol=1e-5,
                                           atol=1e-6)
                err = max(err, float(np.abs(a.cpu().numpy() - want).max()))
        return err

    flat = grads(c["dp"])
    err = check(flat, sync.all_reduce([tree_unflatten(template, g)
                                       for g in flat]))
    api = sync.device_api()
    report = sync.evict(3)
    assert sync.n_ranks == c["dp"] - 1 and api.stale, report
    try:
        api.step_prologue(sync.occl.state)
        refused = False
    except EvictionError:
        refused = True
    assert refused
    flat = grads(sync.n_ranks)
    err = max(err, check(flat, sync.all_reduce(
        [tree_unflatten(template, g) for g in flat])))
    api2 = sync.device_api()
    assert not api2.stale and api2 is not api
    st = api2.step_prologue(sync.occl.state)
    flat = grads(sync.n_ranks)
    for bidx, b in enumerate(sync.buckets):
        data = torch.stack([torch.from_numpy(np.concatenate(
            [f[i].ravel() for i in b.leaf_ids])) for f in flat])
        st = api2.submit_all(st, b.coll_id, data, prio=bidx)
    st = api2.drain(st)
    sync.occl.adopt_state(st)
    got = [sync.unflatten([api2.read(st, r, b.coll_id).float() / sync.n_ranks
                           for b in sync.buckets])
           for r in range(sync.n_ranks)]
    err = max(err, check(flat, got))
    return {"n_ranks": sync.n_ranks, "buckets": len(sync.buckets),
            "replayed": report["replayed"], "stale_refused": refused,
            "max_abs_err": err}


def phase_evict(device) -> dict:
    res = grad_sync_evict(device)
    print(f"[evict] grad sync evict(3): {res['n_ranks']} ranks and "
          f"{res['buckets']} buckets keep averaging (within "
          f"{res['max_abs_err']:.3g} of the float64 average); the DeviceApi "
          f"kept across it is stale and refused a step: "
          f"{res['stale_refused']}; a fresh one ran a step of every bucket")
    return res


# ---------------------------------------------------------------------------
# phase x: the port's examples on the card (4a and 7g run the other two)
# ---------------------------------------------------------------------------

# repro_torch.examples at the reference's sizes, in this order.
# train_dp_occl runs at its full width (64235008 parameters) with its
# fault-tolerant loop at its defaults (60 steps, a failure before step 40,
# checkpoints every 25, in a temporary directory under build/) and its
# OCCL-synced DP loop cut from 30 steps to EXAMPLE_DP_STEPS: at slice 1024
# and burst 1 a step's 64235008 elements take about 94000 supersteps.
EXAMPLE_DP_STEPS = 1
EXAMPLES = (("quickstart", ()), ("elastic_shrink", ()),
            ("hierarchical_allreduce", ()), ("moe_alltoall", ()),
            ("overlap_training", ()),
            ("train_dp_occl", ("--dp-steps", str(EXAMPLE_DP_STEPS))))
_LEDGER = lambda total, hidden: {"supersteps": total, "hidden": hidden,
                                 "exposed": total - hidden}
_STATIC = {"deadlocked": True, "cycle": [0, 1]}
# The reference's counts (tests/test_torch_examples_*.py hold the port's
# examples to the reference's scripts on the CPU); hierarchical_allreduce's
# `auto` picks follow the card's fit (BENCH_torch_calibration.json) and are
# printed, not held.
EXAMPLE_COUNTS = {
    "quickstart": {"completed": 8, "n_ranks": 4, "supersteps": 116,
                   "preempts": 12},
    "elastic_shrink": {
        "holders": [5],
        "tail": "PREEMPT(coll=3), PREEMPT(coll=0), PREEMPT(coll=1)",
        "evict": {"n_ranks": 7, "replayed": 28, "dropped": 0,
                  "generation": 1},
        "supersteps": 156, "fresh_supersteps": 156},
    "hierarchical_allreduce": {
        "chain": [0, 1, 2], "stage_completions": [32, 32, 32],
        "logical_cqes": [0, 0, 32], "steps": {"ring": 31, "two_level": 15},
        "static": _STATIC, "preempts": 96, "launches": 1},
    "moe_alltoall": {
        "program_len": 136, "steps": {"ring": 136, "two_level": 20},
        "moe": {"no-drop": {"cap": 16, "bitwise": True},
                "capacity-dropped": {"cap": 4, "bitwise": True}},
        "static": _STATIC, "preempts": 891, "launches": 1},
    "overlap_training": {
        "dense": {"buckets": 7, "n_ranks": 2, "barrier": _LEDGER(162, 0),
                  "overlapped": _LEDGER(185, 112)},
        "moe": {"barrier": _LEDGER(360, 0),
                "overlapped": _LEDGER(320, 64)}},
    "train_dp_occl": {
        "params": 64235008, "leaves": 14, "dp": 2,
        "ft": {"steps": list(range(40)) + list(range(25, 60)),
               "restarts": 1},
        "dp_loop": {"steps": EXAMPLE_DP_STEPS, "buckets": 11}},
}
TIMEOUT_TEXT = ("28 collectives outstanding after 4 consecutive daemon "
                "launches without progress (5 total)")


def held(res: dict, want: dict) -> dict:
    """The entries of ``res`` that ``want`` names, nested dicts alike."""
    return {k: held(res[k], v) if isinstance(v, dict) else res[k]
            for k, v in want.items()}


def phase_example(name: str, argv, device, card: str) -> dict:
    """``repro_torch.examples.<name>.main`` on ``device`` with its wall
    time (ending in a device sync); its counts held to
    ``EXAMPLE_COUNTS``."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    t0 = time.perf_counter()
    res = mod.main(["--device", str(device), *argv])
    _sync(device)
    res["wall_s"] = time.perf_counter() - t0
    want = EXAMPLE_COUNTS[name]
    got = held(res, want)
    assert got == want, (name, got)
    if name == "elastic_shrink":
        assert TIMEOUT_TEXT in res["timeout"], res["timeout"]
    if name == "hierarchical_allreduce":
        print(f"[example] hierarchical_allreduce: auto picks on the card's "
              f"fit {res['auto']} [{card}]")
    if name == "train_dp_occl":
        # the first step replayed after the recovery must give its first
        # run's loss, bit for bit (as in 7i)
        ft, dp = res["ft"], res["dp_loop"]
        replay = replays(ft["steps"], ft["losses"])
        res["replay_bitwise"] = [a == b for a, b in replay]
        assert res["replay_bitwise"][0], replay
        assert all(np.isfinite(ft["losses"] + dp["losses"])), res
        print(f"[example] train_dp_occl: {res['params']} parameters; ft "
              f"loop {len(ft['steps'])} steps, {ft['restarts']} restart, "
              f"median {np.median(ft['step_ms']):.3f} ms per step, "
              f"replayed losses bitwise equal: {res['replay_bitwise']}; "
              f"occl dp loop {dp['steps']} step(s), {dp['buckets']} "
              f"buckets, {dp['supersteps']} supersteps, s per step "
              f"{[round(x, 3) for x in dp['step_s']]} of which all-reduce "
              f"{[round(x, 3) for x in dp['sync_s']]} "
              f"({1e3 * sum(dp['sync_s']) / dp['supersteps']:.4f} ms per "
              f"superstep with staging and reads), "
              f"{dp['samples_per_s']:.3f} samples/s [{card}]")
    return res


# ---------------------------------------------------------------------------
# phase 7g: repro_torch.examples.serve_batched (the engine, QoS on / off)
# ---------------------------------------------------------------------------

def tenant(n: int, done: int, p50=None, p99=None, mean=None) -> dict:
    """One class's entry of ``ServingQos.summary()`` (None: no sample)."""
    return {"submitted": n, "completed": done, "p50": p50, "p99": p99,
            "mean": mean}


def digest(pre: bool, steps: int, bg: dict, prefill: dict, decode: dict
           ) -> dict:
    """A ``ServingQos.summary()`` with no preempts, as the engine runs
    below end (their preempts happen only in the mid-burst check)."""
    return {"preemption": pre, "supersteps": steps, "preempts": 0,
            "background": bg, "prefill": prefill, "decode": decode}


# The reference's counts on the same traffic (structural: the CPU test
# holds the port's run to them and to the reference's engine and fabric).
# "ticked": the fabric's supersteps after the final drain.
_ENGINE = {"prefills": 3, "decode_steps": 33, "tokens": 120,
           "admissions": 10}
SERVE_BATCHED_COUNTS = {
    "alone": _ENGINE,
    "mid_burst": {"latency": 6, "preempts": 4, "supersteps": 133},
    "preempt_off": {
        "qos": digest(False, 4815, tenant(36, 36, 199.5, 267.0, 196.5),
                      tenant(3, 3, 15.0, 15.0, 15.0),
                      tenant(33, 33, 258.0, 258.0, 143.45454545454547)),
        "background": [36, 36], "ticked": 4815, **_ENGINE},
    "preempt_on": {
        "qos": digest(True, 279, tenant(2, 0),
                      tenant(3, 3, 15.0, 15.0, 15.0),
                      tenant(33, 33, 6.0, 6.0, 6.0)),
        "background": [2, 2], "ticked": 531, **_ENGINE}}
# Phase 7h: Llama-3-8B (src/repro_torch/configs/llama3_8b.py, unchanged) at
# full width and depth, bf16 compute, batch 8, prompt_len 1024, max_len
# 1080, with launch/serve.py --qos's fabric (reference default sizes); 24
# requests, max_new_tokens uniform in 8-48 and prompt lengths uniform in
# 256-1024 (drawn in that order from the seed, so the counts do not depend
# on the prompt lengths), so slots recycle mid-flight.
LLAMA_SERVE = dict(arch="llama3-8b", batch=8, prompt_len=1024, max_len=1080,
                   n_requests=24, prompt_min=256, new_min=8, new_max=48,
                   seed=17)
LLAMA_QOS = dict(n_ranks=4, preemption=True, prio_aging_quantum=8)
# Its counts (structural: the CPU test runs the same traffic through the
# reduced model at prompt_len 16 and holds them).
LLAMA_COUNTS = {
    "prefills": 14, "decode_steps": 101, "tokens": 680, "admissions": 24,
    "requests": 24,
    "qos": digest(True, 931, tenant(2, 0), tenant(14, 14, 15.0, 15.0, 15.0),
                  tenant(101, 101, 6.0, 6.0, 6.0)),
    "background": [2, 2], "drain_supersteps": 252, "ticked": 1183}
# Prefill of S tokens (pad_to) then one decode step against the last
# position of a prefill over the same S + 1 tokens: relative L2 bound of
# the logits by compute dtype (tests/test_torch_serving.py states them).
# Phase 7h runs it in bfloat16 and, on the same parameters upcast, in
# float32.
CACHE_CHECK_REL_L2 = {"float32": 1e-4, "bfloat16": 5e-2}
# Phase 7j's ssm cache check: a prefill of 256 tokens (one ssm_chunk) then
# 256 decode steps against a prefill of 512: relative L2 bounds of the last
# logits and of the final cache (the f32 ``state`` and the conv states) by
# compute dtype.  Set before the first card run from CPU runs of the same
# check at full depth (64 layers), 2 prompts, d_model 256 / 512 / 1024:
# logits in bf16 0.022 / 0.035 / 0.045 (state 0.020 / 0.033 / 0.043), in
# f32 1.6e-06 / - / 6.5e-06; the bounds leave room for d_model 2560.
SSM_CACHE = ("state", "conv_x", "conv_B", "conv_C")
SSM_CACHE_REL_L2 = {
    "float32": {"rel_l2": 1e-4, **dict.fromkeys(SSM_CACHE, 1e-4)},
    "bfloat16": {"rel_l2": 0.15, **dict.fromkeys(SSM_CACHE, 0.15)}}
# The hybrid's cache adds the shared block's K / V (one per application).
CACHE_LEAVES = SSM_CACHE + ("shared_k", "shared_v")
LLAMA_BOUNDS = {dt: {"rel_l2": b} for dt, b in CACHE_CHECK_REL_L2.items()}


def no_nan(tree):
    """``tree`` with every NaN float replaced by None (a tenant with no
    latency sample has NaN percentiles), so that ``==`` compares it."""
    if isinstance(tree, dict):
        return {k: no_nan(v) for k, v in tree.items()}
    if isinstance(tree, float) and tree != tree:
        return None
    return tree


def serve_batched_counts(res: dict) -> dict:
    """The structural part of ``repro_torch.examples.serve_batched``'s
    result (no walls, no tokens): what the card must reproduce."""
    keep = ("prefills", "decode_steps", "tokens", "admissions")
    out = {"alone": {k: res["alone"][k] for k in keep},
           "mid_burst": res["mid_burst"]}
    for key in ("preempt_off", "preempt_on"):
        r = res[key]
        out[key] = {"qos": r["qos"], "background": r["background"],
                    "ticked": r["ticked"],
                    **{k: r["stats"][k] for k in keep}}
    return no_nan(out)


def phase_serve_batched(device, card: str) -> dict:
    """``repro_torch.examples.serve_batched`` at its defaults (llama3-8b
    ``.reduced()``, 10 requests, 12 new tokens each, batch 4, prompt_len
    16): the engine alone, with its QoS fabric (preemption off, on), and a
    decode submitted mid-burst."""
    from repro_torch.examples import serve_batched

    res = serve_batched.main(["--device", str(device)])
    a = res["alone"]
    print(f"[serve batched] engine alone: {a['requests']} requests, "
          f"{a['tokens']} tokens, {a['prefills']} prefills, "
          f"{a['decode_steps']} decode steps in {a['wall_s']:.3f} s; first "
          f"tokens {a['first_tokens']} [{card}]")
    for key in ("preempt_off", "preempt_on"):
        r = res[key]
        q = r["qos"]
        print(f"[serve batched] {key}: decode p50 {q['decode']['p50']:g} / "
              f"p99 {q['decode']['p99']:g} supersteps, prefill p99 "
              f"{q['prefill']['p99']:g}, {q['preempts']} preempts, "
              f"{q['supersteps']} supersteps, background "
              f"{r['background'][0]}/{r['background'][1]} after the drain; "
              f"engine {r['wall_s']:.3f} s [{card}]")
    m = res["mid_burst"]
    print(f"[serve batched] mid-burst decode: {m['latency']} supersteps, "
          f"{m['preempts']} preempts [{card}]")
    on, off = res["preempt_on"]["qos"], res["preempt_off"]["qos"]
    assert on["decode"]["p99"] < off["decode"]["p99"], (on, off)
    for key in ("preempt_off", "preempt_on"):
        done, submitted = res[key]["background"]
        assert submitted > 0 and done == submitted, res[key]
    assert m["preempts"] > 0, m
    got = serve_batched_counts(res)
    assert got == SERVE_BATCHED_COUNTS, got
    return res


# ---------------------------------------------------------------------------
# phase 7h: Llama-3-8B served at full width and depth over the QoS fabric
# ---------------------------------------------------------------------------

def llama_requests(spec: dict, vocab: int) -> list:
    from repro_torch.serving import Request

    rng = np.random.RandomState(spec["seed"])
    n = spec["n_requests"]
    news = rng.randint(spec["new_min"], spec["new_max"] + 1, n)
    lens = rng.randint(spec["prompt_min"], spec["prompt_len"] + 1, n)
    return [Request(rid=i, prompt=rng.randint(0, vocab, size=int(lens[i]),
                                              dtype=np.int32),
                    max_new_tokens=int(news[i])) for i in range(n)]


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def cache_check(model, params, tokens, pad_to, n_decode: int = 1,
                extra: dict | None = None) -> dict:
    """``prefill`` of ``tokens`` but the last ``n_decode`` (cache padded to
    ``pad_to``), then one ``decode_step`` for each of those, against a
    ``prefill`` over all of ``tokens``: relative L2 and max abs error of the
    last logits, the share of rows whose argmax agree, and for an ssm or
    hybrid cache the relative L2 of each leaf of ``CACHE_LEAVES`` (the
    positions the longer prefill holds).  ``extra``: the batch's other
    inputs (``patches``, ``frames``), given to both prefills."""
    import torch

    extra = extra or {}
    S = tokens.shape[1] - n_decode
    V = model.cfg.vocab
    _, cache = model.prefill(params, {"tokens": tokens[:, :S], **extra},
                             pad_to=pad_to)
    for i in range(S, tokens.shape[1]):
        got, cache = model.decode_step(params, cache, tokens[:, i])
    want, full = model.prefill(params, {"tokens": tokens, **extra})
    got, want = got[:, :V].double(), want[:, 0, :V].double()
    assert bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    res = {"rel_l2": rel_l2(got, want),
           "max_abs": float((got - want).abs().max()),
           "scale": float(want.abs().max()),
           "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                 .double().mean())}
    for k in CACHE_LEAVES:
        if k in cache:
            held = tuple(slice(0, n) for n in full[k].shape)
            res[k] = rel_l2(cache[k][held], full[k])
    return res


def stub_inputs(cfg, batch: int, g, device) -> dict:
    """Seeded standard-normal ``patches`` (vlm) or ``frames`` (encdec) for
    a cache check, in the compute dtype: the engine's zero stand-ins leave
    the image positions inert and the encoder's output 0."""
    import torch

    key, n = {"vlm": ("patches", cfg.vis_tokens),
              "encdec": ("frames", cfg.enc_frames)}.get(cfg.family,
                                                        (None, 0))
    if key is None:
        return {}
    x = torch.randn((batch, n, cfg.d_model), generator=g)
    return {key: x.to(device=device, dtype=getattr(torch, cfg.compute_dtype))}


def serve_fullwidth(device, cfg, spec: dict = LLAMA_SERVE,
                    qos_kw: dict = LLAMA_QOS) -> dict:
    """``ServingEngine`` with ``launch/serve.py --qos``'s fabric over
    ``spec``'s traffic; every logit held finite, the token and QoS
    invariants held, then :func:`cache_check` on ``batch`` prompts of
    :func:`check_lengths`.  Model and QoS calls timed on the host clock,
    each ended by a device sync."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine, ServingQos, TrafficClass
    from repro_torch.tree import tree_leaves, tree_map

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qos = ServingQos(**qos_kw, device=device)
    eng = ServingEngine(cfg, batch_size=spec["batch"],
                        prompt_len=spec["prompt_len"],
                        max_len=spec["max_len"], qos=qos, device=device)
    _sync(device)
    leaves = tree_leaves(eng.params)
    res = {"init_s": time.perf_counter() - t0,
           "elems": {k: sum(a.numel() for a in tree_leaves(v))
                     for k, v in eng.params.items()},
           "n_params": sum(a.numel() for a in leaves),
           "param_bytes": sum(a.numel() * a.element_size() for a in leaves),
           "embed_bytes": eng.params["embed"].numel()
           * eng.params["embed"].element_size()}
    if cuda:
        res["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    model_s = split_calls(eng, ("_prefill", "_decode"), device)
    qos_s = split_calls(qos, ("prefill_event", "decode_event"), device)
    finite = [True]

    def checked(fn):
        def call(*a):
            logits, cache = fn(*a)
            finite[0] &= bool(torch.isfinite(logits).all())
            return logits, cache
        return call

    eng._prefill = checked(eng._prefill)
    eng._decode = checked(eng._decode)
    reqs = llama_requests(spec, cfg.vocab)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run()
    _sync(device)
    res["wall_s"] = time.perf_counter() - t0
    for name in ("_prefill", "_decode"):
        delattr(eng, name)
    for name in ("prefill_event", "decode_event"):
        delattr(qos, name)
    st = eng.stats
    q = st["qos"]
    bg = qos.tenants[TrafficClass.BACKGROUND]
    res["drain_supersteps"] = qos.drain()
    res["background"] = [bg.completed, bg.submitted]
    res["ticked"] = qos.summary()["supersteps"]
    res.update({k: st[k] for k in ("prefills", "decode_steps", "tokens",
                                   "admissions")})
    res["qos"] = q
    res["requests"] = len(done)
    res["all_finite"] = finite[0]
    res["model_s"] = model_s
    res["qos_s"] = qos_s
    assert len(done) == len(reqs) == len({r.rid for r in done})
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
    assert st["tokens"] == sum(len(r.out_tokens) for r in done), st
    assert q["decode"]["completed"] == st["decode_steps"], (q, st)
    assert q["prefill"]["completed"] == st["prefills"], (q, st)
    assert bg.submitted > 0 and bg.completed == bg.submitted, res
    assert finite[0]
    if cuda:
        res["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    g = torch.Generator(device="cpu").manual_seed(spec["seed"])
    n_pre, n_dec = check_lengths(spec)
    toks = torch.randint(0, cfg.vocab, (spec["batch"], n_pre + n_dec),
                         generator=g, dtype=torch.int32).to(device)
    extra = stub_inputs(cfg, spec["batch"], g, device)
    res["cache_check"] = cache_check(eng.model, eng.params, toks,
                                     spec["max_len"], n_dec, extra)
    p32 = tree_map(lambda a: a.float(), eng.params)
    m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    res["cache_check_f32"] = cache_check(m32, p32, toks, spec["max_len"],
                                         n_dec, extra)
    if cuda and cfg.family == "encdec":
        res["cross_kv_ms"] = cross_kv_ms(eng, spec["batch"])
    return res


def cross_kv_ms(eng, batch: int) -> float:
    """Device ms of the cross-attention K / V an encdec decode step
    recomputes from ``enc_out`` (every decoder layer's ``mem @ wk`` and
    ``mem @ wv`` on a [batch, enc_frames, D] memory), replayed from a CUDA
    graph: the work a cross-K / V cache would save."""
    import torch

    cfg, cross = eng.cfg, eng.params["layers"]["cross"]
    mem = torch.randn((batch, cfg.enc_frames, cfg.d_model),
                      device=eng.device).to(cross["wk"].dtype)
    ws = [(cross["wk"][i], cross["wv"][i]) for i in range(cfg.n_layers)]

    def fn():
        for wk, wv in ws:
            mem @ wk
            mem @ wv

    return graph_ms(fn)


def check_lengths(spec: dict) -> tuple[int, int]:
    """(prefill, decode steps) of the cache check: one step after a full
    prompt, unless ``spec`` names both (an ssm prefill takes whole
    chunks)."""
    return spec.get("check_prefill", spec["prompt_len"]), \
        spec.get("check_decode", 1)


def llama_counts(res: dict) -> dict:
    """The structural part of :func:`serve_fullwidth`'s result: the
    engine's counts and the fabric's digest (they follow from the traffic's
    ``max_new_tokens`` and the batch alone)."""
    return no_nan({k: res[k] for k in ("prefills", "decode_steps", "tokens",
                                       "admissions", "requests", "qos",
                                       "background", "drain_supersteps",
                                       "ticked")})


def serving_times(res: dict) -> None:
    """Per-call model and QoS times of :func:`serve_fullwidth`'s result."""
    n_pre, n_dec = res["prefills"], res["decode_steps"]
    ms = {k: v * 1e3 for k, v in res["model_s"].items()}
    qms = {k: v * 1e3 for k, v in res["qos_s"].items()}
    res["prefill_ms"] = ms["_prefill"] / n_pre
    res["decode_ms"] = ms["_decode"] / n_dec
    res["qos_prefill_ms"] = qms["prefill_event"] / n_pre
    res["qos_decode_ms"] = qms["decode_event"] / n_dec
    res["decode_bound_ms"] = res["decode_bytes"] / HBM_BYTES_PER_S * 1e3
    res["prefill_tflops"] = res["prefill_flop"] / res["prefill_ms"] / 1e9


def report_serving(tag: str, res: dict, spec: dict, cfg, card: str,
                   bounds: dict) -> None:
    """Print :func:`serve_fullwidth`'s result (its model description
    printed by the caller), hold the cache checks to ``bounds`` (compute
    dtype -> {key: bound}) and the counts to ``LLAMA_COUNTS``."""
    q = res["qos"]
    print(f"[{tag}] {res['requests']} requests, batch {spec['batch']}, "
          f"prompt_len {spec['prompt_len']}, max_len {spec['max_len']}: "
          f"{res['prefills']} prefills, {res['decode_steps']} decode steps, "
          f"{res['admissions']} admissions, {res['tokens']} tokens in "
          f"{res['wall_s']:.3f} s ({res['tokens'] / res['wall_s']:.2f} "
          f"tokens/s); peak {res['serve_peak_bytes'] / 2**30:.2f} GiB while "
          f"serving, cache {res['cache_bytes']} bytes [{card}]")
    print(f"[{tag}] model only (synced host clock): "
          f"{res['prefill_ms']:.3f} ms per prefill "
          f"({res['prefill_flop'] / 1e12:.2f} TFLOP, "
          f"{res['prefill_tflops']:.1f} TFLOP/s), {res['decode_ms']:.3f} ms "
          f"per decode step against a byte bound of "
          f"{res['decode_bound_ms']:.3f} ms ({res['decode_bytes']} bytes) "
          f"[{card}]")
    print(f"[{tag}] QoS fabric: {res['qos_prefill_ms']:.3f} ms per "
          f"prefill event, {res['qos_decode_ms']:.3f} ms per decode event; "
          f"decode p50 {q['decode']['p50']:g} / p99 {q['decode']['p99']:g} "
          f"supersteps, prefill p99 {q['prefill']['p99']:g}, "
          f"{q['preempts']} preempts, {q['supersteps']} supersteps, "
          f"background {res['background'][0]}/{res['background'][1]} after "
          f"a drain of {res['drain_supersteps']} [{card}]")
    n_pre, n_dec = check_lengths(spec)
    for key, dt in (("cache_check", cfg.compute_dtype),
                    ("cache_check_f32", "float32")):
        cc = res[key]
        print(f"[{tag}] cache check in {dt} (prefill {n_pre} + {n_dec} "
              f"decode steps vs prefill {n_pre + n_dec}, {spec['batch']} "
              f"prompts): logits relative L2 {cc['rel_l2']:.3g}, max abs "
              f"{cc['max_abs']:.3g} of logits up to {cc['scale']:.3g}, "
              f"argmax agrees in {cc['argmax_agree']:.3f} of the rows"
              + "".join(f", {k} {cc[k]:.3g}" for k in CACHE_LEAVES
                        if k in cc)
              + f" (bounds {bounds[dt]}) [{card}]")
        for k, bound in bounds[dt].items():
            assert cc[k] <= bound, (dt, k, cc)
    print(f"[{tag}] every logit finite: {res['all_finite']}; "
          f"phase {res['phase_s']:.1f} s [{card}]")
    got = llama_counts(res)
    assert got == LLAMA_COUNTS, got


def serving_costs(cfg, spec: dict, res: dict) -> None:
    """The decode bound's bytes and the prefill's FLOPs of
    :func:`serve_fullwidth`'s model, into ``res``.

    Decode: every weight the step reads once (all but the embedding table,
    the vlm's ``vis_proj`` and the encoder), B embedding rows and every
    cache byte it reads or writes: the padded KV caches read (one slot
    written), the ssm states and conv states read and written, the encdec
    memory read and the cross-attention K / V it recomputes written and
    read again.  Prefill: every weight at every position it applies to
    (the LM head at the last position only, the hybrid's shared block at
    each of its applications, the encoder and the cross-attention's K / V
    projections at every frame, the vlm's image positions), plus QK^T and
    PV over every pair (the plain attention computes the masked half too)
    and the SSD products per chunk (C.B over Q x Q pairs, their weights
    times x, the chunk states and the inter-chunk term)."""
    fam = cfg.family
    B, L, D, S = spec["batch"], cfg.n_layers, cfg.d_model, spec["prompt_len"]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n = res["elems"]
    kv = lambda layers, length: 2 * layers * B * length * KV * dh * 2
    attn = lambda layers, sq, skv: 4 * B * H * sq * skv * dh * layers
    head = D * cfg.vocab
    per_pos = res["n_params"] - n["embed"] - head
    read = res["param_bytes"] - res["embed_bytes"]
    wbytes = res["embed_bytes"] // n["embed"]
    flop = 2 * head * B
    P = S + cfg.vis_tokens if fam == "vlm" else S
    if fam in ("ssm", "hybrid"):
        Hs, Ps, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        GN, K1 = cfg.ssm_groups * N, cfg.ssm_dconv - 1
        cache = (L * B * Hs * N * Ps * 4
                 + L * B * K1 * (cfg.d_inner + 2 * GN) * 2)
        moved = 2 * cache
        Q = min(cfg.ssm_chunk, S)
        flop += 2 * B * S * Hs * (Q * N + Q * Ps + 2 * N * Ps) * L
    else:
        cache = moved = kv(L, spec["max_len"])
        flop += attn(L, P, P)
    if fam == "hybrid":
        n_inv = L // cfg.shared_attn_period
        per_pos += (n_inv - 1) * n["shared"]
        cache += kv(n_inv, spec["max_len"])
        moved += kv(n_inv, spec["max_len"])
        flop += attn(n_inv, S, S)
    elif fam == "vlm":
        per_pos -= n["vis_proj"]
        read -= n["vis_proj"] * wbytes
        flop += 2 * n["vis_proj"] * B * cfg.vis_tokens
    elif fam == "encdec":
        F = cfg.enc_frames
        enc = n["enc_layers"] + n["enc_norm"]
        cross_kv = L * 2 * D * KV * dh
        per_pos -= enc + cross_kv
        read -= enc * wbytes
        flop += (2 * enc * B * F + attn(cfg.enc_layers, F, F)
                 + 2 * cross_kv * B * F + attn(L, S, F))
        cache += B * F * D * 2
        moved += B * F * D * 2 + 2 * kv(L, F)
    res["cache_bytes"] = cache
    res["decode_bytes"] = read + B * D * 2 + moved
    res["prefill_flop"] = flop + 2 * per_pos * B * P


def describe(cfg) -> str:
    """A serving phase's model line: the family's widths."""
    attn = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV of {cfg.d_head}, "
            f"d_ff {cfg.d_ff}")
    ssm = (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} heads of "
           f"{cfg.ssm_headdim}, {cfg.ssm_groups} groups, state "
           f"{cfg.ssm_state}")
    body = {"dense": attn, "ssm": ssm,
            "hybrid": f"{ssm}; one shared attention + SwiGLU block ({attn})"
                      f" after every {cfg.shared_attn_period}th layer",
            "vlm": f"{attn} GeGLU, {cfg.vis_tokens} image tokens, prefix-LM",
            "encdec": f"a {cfg.enc_layers}-layer bidirectional encoder over "
                      f"{cfg.enc_frames} frames, {attn}, cross-attention"}
    return (f"d_model {cfg.d_model}, {cfg.n_layers} layers, "
            f"{body[cfg.family]}, vocab {cfg.vocab}, {cfg.compute_dtype}")


def phase_serve_model(device, card: str, tag: str, spec: dict, bounds: dict,
                      train: dict | None = None) -> dict:
    """A serving phase (7h, 7j, 7k-7m): :func:`serve_fullwidth` on the
    config ``spec["arch"]`` names, unchanged; its costs, times and report
    (cache checks held to ``bounds``, counts to ``LLAMA_COUNTS``); then
    ``train``'s ``make_train_step`` steps at full width, if given."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    t0 = time.perf_counter()
    res = serve_fullwidth(device, cfg, spec)
    res["phase_s"] = time.perf_counter() - t0
    serving_costs(cfg, spec, res)
    serving_times(res)
    print(f"[{tag}] {spec['arch']} ({describe(cfg)}): {res['n_params']} "
          f"parameters, {res['param_bytes']} bytes on the card; engine "
          f"built in {res['init_s']:.3f} s, peak "
          f"{res['init_peak_bytes'] / 2**30:.2f} GiB during init [{card}]")
    report_serving(tag, res, spec, cfg, card, bounds)
    if "cross_kv_ms" in res:
        print(f"[{tag}] the cross K / V a decode step recomputes "
              f"({2 * cfg.n_layers} projections of [{spec['batch']} x "
              f"{cfg.enc_frames}, {cfg.d_model}] @ [{cfg.d_model}, "
              f"{cfg.n_kv_heads * cfg.d_head}]): {res['cross_kv_ms']:.3f} ms "
              f"of device time, graph-replayed, of {res['decode_ms']:.3f} ms "
              f"per decode step [{card}]")
    if train is not None:
        free_card()
        tr = res["train"] = train_steps(device, cfg, train)
        print(f"[{tag}] training at full width (make_train_step, batch "
              f"{train['batch']}, seq {train['seq']}): state built in "
              f"{tr['init_s']:.3f} s, losses {tr['losses']}, ms per step "
              f"{[round(x, 3) for x in tr['step_ms']]}, peak "
              f"{tr['peak_bytes'] / 2**30:.2f} GiB [{card}]")
    print(f"[{tag}] summary " + json.dumps(no_nan(res)))
    return res


# ---------------------------------------------------------------------------
# phase 7i: the default training entry point at Qwen3-0.6B's full width
# ---------------------------------------------------------------------------

# launch/train.py's default path (fabric/ft.py TrainController, async
# checkpoints) on qwen3-0.6b exactly as src/repro_torch/configs/qwen3_0p6b.py
# gives it (751894528 parameters; params, m and v in f32: 9.02 GB per
# checkpoint), at the reference CLI's batch 8 and seq 64: 8 steps with a
# checkpoint every 4 (keep 2) and a failure injected before step 6, so the
# loop restores step 4 and replays steps 4 and 5; then launch/train.py's
# main with --resume --steps 10.
TRAIN_DEFAULT = dict(arch="qwen3-0.6b", reduced=False, batch=8, seq=64,
                     ckpt_period=4, keep=2, fail_at=6, steps=8,
                     resume_steps=10)
CKPT_COPIES = 3     # keep=2 committed steps and the step being written
REPLAY_RTOL = 1e-5  # the second replayed step's loss against its first run
# Then REMAT_STEPS make_train_step steps at the same width and batch under
# cfg.remat "full" (the config's) and "dots" (the 2-D products saved), each
# from a fresh state on the same batches.
REMAT_STEPS = 2


def bit_equal(a, b) -> bool:
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def replays(steps: list, losses: list) -> list:
    """(first run's loss, replayed loss) of the first two steps a recovery
    replays: those after the point where the step numbers fall back."""
    fail = next(i for i in range(1, len(steps)) if steps[i] <= steps[i - 1])
    first = dict(zip(steps[:fail], losses[:fail]))
    return [(first[s], loss) for s, loss in
            zip(steps[fail:fail + 2], losses[fail:fail + 2])]


def timed_calls(mod, names) -> tuple[dict, dict, callable]:
    """Wrap the module-level functions ``names`` of ``mod`` with host-clock
    timers; returns ``(seconds, calls, undo)``: the first two keyed by
    ``(name, on the main thread)``, ``undo()`` puts the originals back."""
    import threading

    spent, calls = {}, {}
    untimed = {n: getattr(mod, n) for n in names}
    for name in names:
        def timed(*a, _fn=untimed[name], _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                key = (_name, threading.current_thread()
                       is threading.main_thread())
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                calls[key] = calls.get(key, 0) + 1
        setattr(mod, name, timed)
    return spent, calls, lambda: [setattr(mod, n, f)
                                  for n, f in untimed.items()]


def train_default(device, spec: dict, workdir: pathlib.Path) -> dict:
    """``TrainController(..., inject_failure_at=fail_at).run(steps)`` with
    async checkpoints in a temporary directory under ``workdir``, then
    ``launch/train.py``'s ``main`` with ``--resume``: the recovery, the
    replayed losses and the resumed state held, checkpoint I/O timed."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.fabric.ft import FTConfig, TrainController
    from repro_torch.launch import train as launch_train
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(spec["arch"])
    cfg = cfg.reduced() if spec["reduced"] else cfg
    cuda = torch.device(device).type == "cuda"
    res = {"state_bytes": sum(a.numel() * a.element_size() for a in
                              tree_leaves(init_state(cfg, device="meta")))}
    workdir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir, prefix="ckpt_") as d:
        res["disk_free_bytes"] = shutil.disk_usage(d).free
        need = CKPT_COPIES * res["state_bytes"]
        if res["disk_free_bytes"] < need:
            raise RuntimeError(f"{res['disk_free_bytes']} bytes free under "
                               f"{workdir}, the checkpoints need {need}")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_state(cfg, device=device)
        _sync(device)
        res["init_s"] = time.perf_counter() - t0
        pipe = SyntheticPipeline(cfg, ShapeCell("cli", spec["seq"],
                                                spec["batch"], "train"))
        ctrl = TrainController(
            FTConfig(ckpt_dir=d, ckpt_period=spec["ckpt_period"],
                     keep=spec["keep"]),
            make_train_step(cfg), state, pipe.start(),
            inject_failure_at=spec["fail_at"])
        del state
        spent, calls, untime = timed_calls(
            ckpt, ("save", "_host", "_write", "_crc32", "_read"))
        try:
            recover_s = split_calls(ctrl, ("_recover",), device)
            try:
                logs = ctrl.run(spec["steps"])
            finally:
                pipe.stop()
            final = ctrl.state
            restored = {}
            untimed_restore = ckpt.restore

            def spy(*a, **kw):
                t1 = time.perf_counter()
                tree, extras = untimed_restore(*a, **kw)
                _sync(device)
                restored.update(
                    step=a[1], s=time.perf_counter() - t1,
                    bit_equal=all(bit_equal(x, y) for x, y in zip(
                        tree_leaves(tree), tree_leaves(final))))
                return tree, extras

            ckpt.restore = spy
            try:
                resumed = launch_train.main(
                    ["--arch", cfg.name, "--steps", str(spec["resume_steps"]),
                     "--batch", str(spec["batch"]), "--seq", str(spec["seq"]),
                     "--ckpt-dir", d, "--resume", "--device", str(device)]
                    + (["--reduced"] if spec["reduced"] else []))
            finally:
                ckpt.restore = untimed_restore
        finally:
            untime()
        if cuda:
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
    steps, fail, period = spec["steps"], spec["fail_at"], spec["ckpt_period"]
    last = fail // period * period
    res.update(
        losses=[m["loss"] for m in logs], steps=[m["step"] for m in logs],
        step_ms=[m["step_time_s"] * 1e3 for m in logs],
        restarts=ctrl.restarts, final_step=int(final.step),
        recover_s=recover_s["_recover"], resume=restored,
        resumed_steps=[m["step"] for m in resumed.metrics_log],
        resumed_losses=[m["loss"] for m in resumed.metrics_log],
        resumed_final_step=int(resumed.state.step),
        saves=calls[("save", False)],
        io={f"{n}_{'main' if main else 'writer'}": v
            for (n, main), v in spent.items()})
    res["bytes_written"] = res["saves"] * res["state_bytes"]
    assert res["steps"] == list(range(fail)) + list(range(last, steps)), res
    assert res["restarts"] == 1 and res["final_step"] == steps, res
    replay = replays(res["steps"], res["losses"])
    res["replay_bitwise"] = [a == b for a, b in replay]
    assert res["replay_bitwise"][0], replay
    first, again = replay[1]
    assert abs(again - first) <= REPLAY_RTOL * abs(first), replay
    assert all(np.isfinite(res["losses"] + res["resumed_losses"])), res
    assert restored["step"] == steps and restored["bit_equal"], restored
    assert res["resumed_steps"] == list(range(steps, spec["resume_steps"]))
    assert res["resumed_final_step"] == spec["resume_steps"], res
    return res


def remat_steps(device, spec: dict) -> dict:
    """``REMAT_STEPS`` train steps under each remat policy: ms per step
    (host clock, synced), peak memory, losses.  The first step's loss is
    the same forward under both policies, so it must be bitwise equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    base = get_config(spec["arch"])
    base = base.reduced() if spec["reduced"] else base
    pipe = SyntheticPipeline(base, ShapeCell("cli", spec["seq"],
                                             spec["batch"], "train"))
    cuda = torch.device(device).type == "cuda"
    out = {}
    for policy in ("full", "dots"):
        free_card()     # the peak must not count an earlier phase's garbage
        cfg = dataclasses.replace(base, remat=policy)
        state = init_state(cfg, device=device)
        step = make_train_step(cfg)
        _sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for i in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, pipe.batch_at(i))
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[policy] = {"step_ms": ms, "losses": losses,
                       "peak_bytes": (torch.cuda.max_memory_allocated()
                                      if cuda else None)}
        del state, step
    free_card()
    assert out["dots"]["losses"][0] == out["full"]["losses"][0], out
    assert all(np.isfinite(out[p]["losses"]).all() for p in out), out
    return out


def phase_train_default(device, card: str) -> dict:
    spec = TRAIN_DEFAULT
    t0 = time.perf_counter()
    res = train_default(device, spec, ROOT / "build")
    res["phase_s"] = time.perf_counter() - t0
    io, n = res["io"], res["saves"]
    gb = res["state_bytes"] / 1e9
    print(f"[train default] {spec['arch']} at full width (batch "
          f"{spec['batch']}, seq {spec['seq']}): state {res['state_bytes']} "
          f"bytes ({gb:.2f} GB per checkpoint), built in "
          f"{res['init_s']:.3f} s; {res['disk_free_bytes'] / 1e9:.1f} GB "
          f"free before the phase [{card}]")
    print(f"[train default] steps {res['steps']}: ms per step "
          f"{[round(x, 3) for x in res['step_ms']]}; losses "
          f"{res['losses']}; restarts {res['restarts']}, final step "
          f"{res['final_step']}; replayed losses bitwise equal: "
          f"{res['replay_bitwise']} [{card}]")
    print(f"[train default] {n} saves, {res['bytes_written'] / 1e9:.2f} GB "
          f"written: {io['save_writer'] / n:.3f} s per save in the writer "
          f"thread = write {io['_write_writer'] / n:.3f} s + crc "
          f"{io['_crc32_writer'] / n:.3f} s (+ the rest), after a host copy "
          f"of {io['_host_main'] / n:.3f} s on the training thread; "
          f"restores: recovery {res['recover_s']:.3f} s, --resume "
          f"{res['resume']['s']:.3f} s (read {io.get('_read_main', 0):.3f} s "
          f"and crc {io.get('_crc32_main', 0):.3f} s for both) [{card}]")
    print(f"[train default] --resume: restored step {res['resume']['step']} "
          f"bit-equal to the controller's final state: "
          f"{res['resume']['bit_equal']}; steps {res['resumed_steps']} "
          f"losses {res['resumed_losses']}; peak "
          f"{res['peak_bytes'] / 2**30:.2f} GiB; phase {res['phase_s']:.1f} "
          f"s [{card}]")
    remat = remat_steps(device, spec)
    for policy, r in remat.items():
        print(f"[train default] remat={policy}: {REMAT_STEPS} steps from a "
              f"fresh state, ms per step {[round(x, 3) for x in r['step_ms']]}"
              f", losses {r['losses']}, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB [{card}]")
    res["remat"] = remat
    print("[train default] summary " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 7n: the sharding layer on the card (runs after 7i)
# ---------------------------------------------------------------------------

# Qwen3-0.6B's full-width train state (as 7i builds it; 9.02 GB) laid out
# under state_shardings on a 4x2 ("data", "model") placement mesh of 8 x
# cuda, saved, and restored onto a 2x2 mesh (the reference's elastic
# reshard, tests/test_meshbackend.py); the plan of the same state on a 1x1
# planning mesh against the card's allocated bytes; the dry run of
# llama3-8b decode_32k on the 16x16 planning mesh (a CPU subprocess, run
# while the card phase goes on).
SHARDED = dict(arch="qwen3-0.6b", save_mesh=(4, 2), restore_mesh=(2, 2),
               dryrun=("llama3-8b", "decode_32k"))
ALLOC_ROUNDING = 512      # bytes the caching allocator may add per leaf
PLAN_STATE = """
import sys
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import state_plan_bytes
from repro_torch.launch.mesh import make_planning_mesh
print(state_plan_bytes(get_config(sys.argv[2]),
                       make_planning_mesh((1, 1), ("data", "model"))))
"""


def position_bytes(tree) -> dict:
    """Bytes each mesh position holds over a tree of sharded leaves."""
    from repro_torch.tree import tree_leaves

    out = {}
    for leaf in tree_leaves(tree):
        for pos, n in leaf.nbytes_by_position().items():
            out[pos] = out.get(pos, 0) + n
    return out


def sharded_restore(device, spec: dict, workdir: pathlib.Path) -> dict:
    """Save the state from the save mesh, restore it onto the restore
    mesh: bit-equal leaves, a device set of every restore position."""
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import device_put
    from repro_torch.train.state import init_state, state_shardings
    from repro_torch.tree import tree_leaves, tree_unflatten

    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    arch, cell = spec["dryrun"]
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--cell", cell], cwd=str(ROOT), env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    plan = subprocess.Popen(
        [sys.executable, "-c", PLAN_STATE, str(ROOT / "src"), spec["arch"]],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    cfg = get_config(spec["arch"])
    res = {}
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    state = init_state(cfg, device=device)
    torch.cuda.synchronize()
    leaves = tree_leaves(state)
    res["allocated_bytes"] = torch.cuda.memory_allocated() - m0
    res["state_bytes"] = sum(a.numel() * a.element_size() for a in leaves)
    res["leaves"] = len(leaves)

    n = spec["save_mesh"][0] * spec["save_mesh"][1]
    save_mesh = make_host_mesh(spec["save_mesh"][1], [device] * n)
    t0 = time.perf_counter()
    st8 = tree_unflatten(state, [device_put(a, s) for a, s in zip(
        leaves, tree_leaves(state_shardings(save_mesh, cfg, state)))])
    torch.cuda.synchronize()
    res["put_s"] = time.perf_counter() - t0
    res["save_position_bytes"] = sorted(position_bytes(st8).values())
    workdir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir, prefix="sharded_") as d:
        t0 = time.perf_counter()
        save(d, 0, st8)
        res["save_s"] = time.perf_counter() - t0
        res["bytes_written"] = sum(
            f.stat().st_size for f in pathlib.Path(d).rglob("*.npy"))
        del st8
        n = spec["restore_mesh"][0] * spec["restore_mesh"][1]
        mesh = make_host_mesh(spec["restore_mesh"][1], [device] * n)
        t0 = time.perf_counter()
        got, _ = restore(d, 0, state,
                         shardings=state_shardings(mesh, cfg, state))
        torch.cuda.synchronize()
        res["restore_s"] = time.perf_counter() - t0
    restored = tree_leaves(got)
    res["bit_equal"] = all(bit_equal(r.gather(), a)
                           for r, a in zip(restored, leaves))
    res["device_sets"] = sorted({len(r.sharding.device_set)
                                 for r in restored})
    res["restore_position_bytes"] = sorted(position_bytes(got).values())
    del got, restored, state, leaves

    out, err = plan.communicate(timeout=300)
    assert plan.returncode == 0, err[-3000:]
    res["plan_state_bytes"] = int(out.split()[-1])
    out, err = dry.communicate(timeout=300)
    assert dry.returncode == 0, err[-3000:]
    res["dryrun"] = json.loads(out[out.index("{"):])
    assert res["bit_equal"], res
    assert res["device_sets"] == [n], res
    assert 0 <= res["allocated_bytes"] - res["plan_state_bytes"] \
        <= ALLOC_ROUNDING * res["leaves"], res
    return res


def phase_sharded_restore(device, card: str) -> dict:
    spec = SHARDED
    t0 = time.perf_counter()
    res = sharded_restore(device, spec, ROOT / "build")
    res["phase_s"] = time.perf_counter() - t0
    gb = res["bytes_written"] / 1e9
    print(f"[sharded restore] {spec['arch']} train state "
          f"{res['state_bytes']} bytes: laid out on {spec['save_mesh']} "
          f"x cuda in {res['put_s']:.3f} s (bytes per position "
          f"{res['save_position_bytes']}), saved in {res['save_s']:.3f} s "
          f"({gb:.2f} GB written), restored onto {spec['restore_mesh']} in "
          f"{res['restore_s']:.3f} s (bytes per position "
          f"{res['restore_position_bytes']}); every leaf bit-equal: "
          f"{res['bit_equal']}, device sets {res['device_sets']} [{card}]")
    print(f"[sharded restore] the 1x1 plan's state bytes "
          f"{res['plan_state_bytes']} against {res['allocated_bytes']} "
          f"allocated by init_state on the card ({res['leaves']} leaves) "
          f"[{card}]")
    dry = res["dryrun"]
    print(f"[sharded restore] dry run {dry['arch']} {dry['cell']} on "
          f"{dry['mesh']} (the card machine's CPU): per device arguments "
          f"{dry['mem_argument_bytes']}, outputs {dry['mem_output_bytes']}, "
          f"temp {dry['mem_temp_bytes']} bytes; FLOPs "
          f"{dry['rolled']['flops']} (per device "
          f"{dry['rolled']['flops_per_device']}); collectives "
          f"{json.dumps(dry['rolled']['collectives'])}; plan_s "
          f"{dry['plan_s']}; phase {res['phase_s']:.1f} s [{card}]")
    print("[sharded restore] summary " + json.dumps(
        {k: v for k, v in res.items() if k != "dryrun"}))
    return res


# ---------------------------------------------------------------------------
# phase 7j: Mamba2-2.7B served at full width and depth over the QoS fabric,
# then two training steps at full width
# ---------------------------------------------------------------------------

# src/repro_torch/configs/mamba2_2p7b.py unchanged (64 layers, d_model 2560,
# d_inner 5120, 80 heads of 64, 8 groups, state 128, vocab 50280, bf16
# compute, 3126248960 parameters), served on phase 7h's traffic and fabric;
# the cache check takes whole ssm_chunks (256).  Then make_train_step at the
# reference CLI's batch 8 and seq 64 (its TrainState is 37.5 GB: no
# checkpoint).
SSM_SERVE = dict(LLAMA_SERVE, arch="mamba2-2.7b", check_prefill=256,
                 check_decode=256)
SSM_TRAIN = dict(batch=8, seq=64, steps=2)
# Phases 7k-7m: the hybrid, vlm and encdec families, each config unchanged,
# served on phase 7h's traffic and fabric.  7k: zamba2-1.2b (38 Mamba2
# layers, d_model 2048, d_inner 4096, 64 heads of 64, 2 groups, state 64,
# chunk 256, and one shared attention + SwiGLU block (32 heads of 64, d_ff
# 8192) applied after every 6th layer, 6 times; 1188848256 parameters),
# its cache check and training steps as 7j's.  7l: paligemma-3b (18 layers,
# d_model 2048, 8 heads / 1 KV of 256, GeGLU d_ff 16384, vocab 257216, 256
# image tokens; 3039897600 parameters) with max_len 256 + 1024 + 56, so
# the cache holds the image, the longest prompt and its new tokens.  7m:
# seamless-m4t-large-v2 (a 24-layer encoder over 1024 frames, a 24-layer
# decoder with cross-attention, d_model 1024, 16 heads of 64, d_ff 8192,
# vocab 256206; 2034886656 parameters).
HYBRID_SERVE = dict(SSM_SERVE, arch="zamba2-1.2b")
VLM_SERVE = dict(LLAMA_SERVE, arch="paligemma-3b", max_len=256 + 1024 + 56)
ENCDEC_SERVE = dict(LLAMA_SERVE, arch="seamless-m4t-large-v2")
# 7k's cache bounds, set before the first card run from CPU runs of the
# same check at full depth (38 layers, 6 shared applications) and narrower
# widths: see PERF.md.
HYBRID_CACHE_REL_L2 = {
    "float32": {"rel_l2": 1e-4, **dict.fromkeys(CACHE_LEAVES, 1e-4)},
    "bfloat16": {"rel_l2": 0.15, **dict.fromkeys(CACHE_LEAVES, 0.15)}}
SERVE_FAMILIES = (("serve hybrid", HYBRID_SERVE, HYBRID_CACHE_REL_L2,
                   SSM_TRAIN),
                  ("serve vlm", VLM_SERVE, LLAMA_BOUNDS, None),
                  ("serve encdec", ENCDEC_SERVE, LLAMA_BOUNDS, None))


def train_steps(device, cfg, spec: dict) -> dict:
    """``spec["steps"]`` steps of ``make_train_step`` from a fresh state:
    losses (finite), ms per step, peak memory."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, device=device)
    _sync(device)
    res = {"init_s": time.perf_counter() - t0, "losses": [], "step_ms": []}
    pipe = SyntheticPipeline(cfg, ShapeCell("cli", spec["seq"],
                                            spec["batch"], "train"))
    step = make_train_step(cfg)
    for _ in range(spec["steps"]):
        t0 = time.perf_counter()
        state, metrics = step(state, next(pipe))
        _sync(device)
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["losses"].append(float(metrics["loss"]))
    if cuda:
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(res["losses"])), res
    assert int(state.step) == spec["steps"]
    return res


# ---------------------------------------------------------------------------
# phase 7f: ViT-Base data-parallel training over OCCL at full width
# ---------------------------------------------------------------------------

def check_average(per_rank: list, averaged: list) -> float:
    """Every rank's OCCL-averaged grads within rtol 1e-4 / atol 1e-6 of the
    float64 average of the per-rank grads; returns the max abs error."""
    import torch
    from repro_torch.tree import tree_leaves

    ranks = [tree_leaves(g) for g in per_rank]
    avgs = [tree_leaves(g) for g in averaged]
    err = 0.0
    for i in range(len(ranks[0])):
        want = torch.stack([g[i] for g in ranks]).double().mean(0)
        for a in avgs:
            diff = (a[i].double() - want).abs()
            assert bool(torch.isfinite(a[i]).all()), i
            assert bool((diff <= 1e-6 + 1e-4 * want.abs()).all()), (
                i, float(diff.max()))
            err = max(err, float(diff.max()))
    return err


def check_buckets_once(sync, c0: np.ndarray, c1: np.ndarray) -> None:
    """Every bucket completed exactly once on every rank in one step."""
    for b in sync.buckets:
        assert (c1[:, b.coll_id] - c0[:, b.coll_id] == 1).all(), (
            b.coll_id, c1[:, b.coll_id] - c0[:, b.coll_id])


def phase_vit(device, card: str) -> dict:
    """ViT-Base at full width and ``VIT["n_layers"]`` layers over 4
    simulated DP ranks through OCCL: ``VIT_HOST_STEPS`` host-driven steps
    of ``run_occl_dp``, then one ``make_overlap_grads_step`` step at
    ``VIT_OVERLAP_TICKS`` ticks per boundary and one at 0 (barrier), each
    held against the float64 average of the per-rank grads, every bucket
    completed once per rank."""
    import argparse

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import fused_slice as fs
    from repro_torch.launch.train import run_occl_dp
    from repro_torch.train.step import (make_grads_step,
                                        make_overlap_grads_step)

    full = get_config(VIT["arch"])
    cfg = dataclasses.replace(full, n_layers=VIT["n_layers"])
    print(f"[vit] {VIT['arch']} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}), {cfg.n_layers} of its "
          f"{full.n_layers} layers [{card}]")
    cell = ShapeCell("vit", 0, VIT["batch"], "train")
    args = argparse.Namespace(
        dp=VIT["dp"], steps=VIT_HOST_STEPS,
        bucket_elems=VIT["bucket_elems"], slice_elems=VIT["slice_elems"],
        burst_slices=VIT["burst_slices"])
    prev = {"completed": None, "launches": fs.fused_burst.launches}
    host = []

    def on_step(step, per_rank, synced, sync):
        c1 = sync.stats()["completed"]
        c0 = prev["completed"] if prev["completed"] is not None \
            else np.zeros_like(c1)
        check_buckets_once(sync, c0, c1)
        err = check_average(per_rank, synced)
        prev["completed"] = c1
        launches = fs.fused_burst.launches - prev["launches"]
        prev["launches"] = fs.fused_burst.launches
        host.append({"max_abs_err": err, "fused_burst_launches": launches})

    torch.cuda.reset_peak_memory_stats()
    out = run_occl_dp(cfg, cell, args, device, on_step=on_step)
    states, sync, pipes = out["states"], out["sync"], out["pipes"]
    rt_cfg = sync.occl.cfg
    assert (rt_cfg.n_ranks, rt_cfg.max_colls, rt_cfg.conn_depth,
            rt_cfg.heap_elems) == tuple(VIT_RUNTIME.values()), rt_cfg
    for rec, extra in zip(out["log"], host):
        rec.update(extra, samples_per_s=VIT["batch"] / rec["wall_s"])
        print(f"[vit] host-driven step {rec['step']}: {rec['wall_s']:.3f} s "
              f"wall, {rec['supersteps']} supersteps, "
              f"{rec['fused_burst_launches']} fused_burst launches, "
              f"{rec['samples_per_s']:.3f} samples/s, loss "
              f"{rec['loss']:.5f}, grads within {rec['max_abs_err']:.3g} of "
              f"the float64 average [{card}]")
    params = [s.params for s in states]
    batches = [next(p) for p in pipes]
    for p in pipes:
        p.stop()
    grads_fn = make_grads_step(cfg)
    compute = []
    for _ in range(2):              # the per-rank backward alone, no sync
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_rank = [grads_fn(s, b) for s, b in zip(states, batches)]
        torch.cuda.synchronize()
        compute.append(time.perf_counter() - t0)
    compute_s = min(compute)
    grads = [g for _, g in per_rank]
    steps = {}
    for mode, k in (("overlap", VIT_OVERLAP_TICKS), ("barrier", 0)):
        step = make_overlap_grads_step(cfg, sync, ticks_per_boundary=k,
                                       drain_iters=VIT_DRAIN_ITERS)
        s0 = sync.stats()
        n0 = fs.fused_burst.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, losses, got = step(sync.occl.state, params, batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sync.occl.adopt_state(st)
        s1 = sync.stats()
        check_buckets_once(sync, s0["completed"], s1["completed"])
        rec = dict(step_counts(s0, s1), wall_s=wall,
                   samples_per_s=VIT["batch"] / wall,
                   fused_burst_launches=fs.fused_burst.launches - n0,
                   loss=float(losses.mean()),
                   max_abs_err=check_average(grads, got))
        assert bool(torch.isfinite(losses).all()), losses
        assert rec["hidden_supersteps"] + rec["exposed_supersteps"] \
            == rec["supersteps"], rec
        assert (rec["hidden_supersteps"] > 0) == (k > 0), rec
        steps[mode] = rec
        del got, st
    # The record's model of a step (benchmarks/bench_training.py): hidden
    # supersteps are free, exposed ones cost the barrier run's per-superstep
    # time beyond the compute.
    superstep_s = max((steps["barrier"]["wall_s"] - compute_s)
                      / max(steps["barrier"]["exposed_supersteps"], 1), 1e-9)
    for mode, rec in steps.items():
        rec["step_s_modeled"] = (compute_s + rec["exposed_supersteps"]
                                 * superstep_s)
        ticks = VIT_OVERLAP_TICKS if mode == "overlap" else 0
        print(f"[vit] {mode} step ({ticks} ticks per boundary): "
              f"{rec['wall_s']:.3f} s wall, "
              f"{rec['supersteps']} supersteps ({rec['exposed_supersteps']} "
              f"exposed, {rec['hidden_supersteps']} hidden, "
              f"{rec['tick_calls']} tick calls), "
              f"{rec['fused_burst_launches']} fused_burst launches, "
              f"{rec['samples_per_s']:.3f} samples/s, modeled step "
              f"{rec['step_s_modeled']:.4f} s, loss {rec['loss']:.5f}, grads "
              f"within {rec['max_abs_err']:.3g} of the float64 average "
              f"[{card}]")
    peak = torch.cuda.max_memory_allocated()
    res = {"host_steps": out["log"], "overlap": steps["overlap"],
           "barrier": steps["barrier"], "compute_s": compute_s,
           "superstep_s_modeled": superstep_s, "peak_bytes": peak,
           "buckets": [b.total for b in sync.buckets], "cfg": rt_cfg}
    print(f"[vit] compute alone (4 per-rank backward passes) "
          f"{compute_s:.4f} s; modeled superstep {superstep_s * 1e3:.4f} ms; "
          f"{len(sync.buckets)} buckets {res['buckets']}; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    return res


def phase_vit_profile(rt_cfg, n: int, card: str) -> dict:
    """Device time per superstep at the ViT cell's runtime shape (R=4,
    L=1, B=8, SL=1024, C=9, K=24): one profiled launch of
    ``PROFILE_STEPS`` supersteps of one bucket of ``n`` elements (the
    cell's largest)."""
    import dataclasses

    from repro_torch import core

    cfg = dataclasses.replace(rt_cfg, heap_elems=4 * (2 * n + 64),
                              superstep_budget=PROFILE_STEPS,
                              quit_threshold=PROFILE_STEPS)
    rt = core.OcclRuntime(cfg, device="cuda")
    cid = rt.register(core.CollKind.ALL_REDUCE,
                      rt.communicator(list(range(cfg.n_ranks))), n_elems=n)
    rt.submit_all(cid, data=np.ones(n, np.float32))
    res = profile_launch(rt, "vit R=4", card)
    del rt
    free_card()
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
# phase 8: where the time goes (short profiled launches at real size)
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
    t_start = time.perf_counter()
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

    def main_path(name, fn, fabric=True):
        """Drive ``fn`` with the launch counts set to 0 first; a path over
        the OCCL fabric must launch ``fused_burst``, one without (the
        checkpoint path) must launch no kernel."""
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        paths[name] = tuple(k.launches for k in counters)
        print(f"[path] {name}: fused_burst launches {paths[name][0]}, "
              f"fused_primitive launches {paths[name][1]}, chunk_combine "
              f"launches {paths[name][2]}; {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        if fabric:
            assert paths[name][0] > 0, (name, paths[name])
        else:
            assert paths[name] == (0, 0, 0), (name, paths[name])
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
    free_card()
    t0 = time.perf_counter()
    twin = main_path("mesh twin (sim)", lambda: mesh_runs(device, card))
    mesh = main_path("mesh", lambda: mesh_runs(
        device, card, [device] * MESH_CELL["n_ranks"]))
    check_mesh(twin, mesh)
    assert paths["mesh"][0] >= MESH_CELL["n_ranks"] * mesh["real"][
        "supersteps"], paths["mesh"]
    mixed = [device] * 4 + [torch.device("cpu")] * 4
    two = main_path("mesh over cuda and cpu", lambda: mesh_runs(
        device, card, mixed, real=False))
    check_mesh(twin, two)
    # The four CUDA ranks launch fused_burst once each per superstep.
    assert paths["mesh over cuda and cpu"][0] >= 4 * sum(
        s for w in two.values() for s, _, _ in
        mesh_summary(w["counts"]).values()), paths["mesh over cuda and cpu"]
    print(f"[mesh] mesh real size: {mesh['real']['wall_ms_per_superstep']:.4f}"
          f" ms wall / {mesh['real']['event_ms_per_superstep']:.4f} ms "
          f"between CUDA events per superstep against the sim's "
          f"{twin['real']['wall_ms_per_superstep']:.4f} / "
          f"{twin['real']['event_ms_per_superstep']:.4f}; phase 4d "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    del twin, mesh, two
    free_card()
    main_path("train record", lambda: phase_train_record(device))
    moe = main_path("moe record", lambda: phase_moe_record(device))
    assert paths["moe record"][0] >= sum(
        moe[m]["supersteps"] for m in MOE_STEPS)
    serving = main_path("serving", lambda: phase_serving(device, card))
    assert paths["serving"][0] >= sum(r["supersteps"]
                                      for r in serving.values())
    main_path("evict", lambda: phase_evict(device))
    free_card()
    t0 = time.perf_counter()
    for name, argv in EXAMPLES:
        tag = f"example {name}"
        res = main_path(tag, lambda: phase_example(name, argv, device, card))
        f = res["fabric"]
        print(f"[example] {name}: wall {res['wall_s']:.3f} s, "
              f"{f['supersteps']} supersteps, {f['preempts']} preempts, "
              f"fused_burst launches {paths[tag][0]} [{card}]")
        assert paths[tag][0] >= f["supersteps"], (tag, paths[tag], f)
        del res
        free_card()
    print(f"[example] phase x {time.perf_counter() - t0:.1f} s [{card}]")
    full = main_path("moe fullwidth",
                     lambda: phase_moe_fullwidth(device, card))
    assert paths["moe fullwidth"][0] >= sum(
        full[m]["supersteps"] for m in MOE_STEPS)
    free_card()
    serve = main_path("serve batched",
                      lambda: phase_serve_batched(device, card))
    assert paths["serve batched"][0] >= sum(
        serve[k]["ticked"] for k in ("preempt_off", "preempt_on"))
    llama = main_path("serve fullwidth", lambda: phase_serve_model(
        device, card, "serve fullwidth", LLAMA_SERVE, LLAMA_BOUNDS))
    assert paths["serve fullwidth"][0] >= llama["ticked"]
    free_card()
    main_path("train default", lambda: phase_train_default(device, card),
              fabric=False)
    free_card()
    main_path("sharded restore", lambda: phase_sharded_restore(device, card),
              fabric=False)
    free_card()
    ssm = main_path("serve ssm", lambda: phase_serve_model(
        device, card, "serve ssm", SSM_SERVE, SSM_CACHE_REL_L2, SSM_TRAIN))
    assert paths["serve ssm"][0] >= ssm["ticked"]
    free_card()
    for tag, spec, bounds, train in SERVE_FAMILIES:
        res = main_path(tag, lambda: phase_serve_model(
            device, card, tag, spec, bounds, train))
        assert paths[tag][0] >= res["ticked"]
        del res
        free_card()
    vit = main_path("vit", lambda: phase_vit(device, card))
    assert paths["vit"][0] >= sum(r["supersteps"] for r in vit["host_steps"])
    free_card()
    phase_profile(device, card)
    vit["profile"] = phase_vit_profile(vit.pop("cfg"), max(vit["buckets"]),
                                       card)
    print("[vit] summary " + json.dumps(vit))

    entries = (burst_entry, fused_entry, combine_entry)
    for i, entry in enumerate(entries):
        entry["launches"] = sum(p[i] for p in paths.values())
        entry["launches_by_path"] = {k: p[i] for k, p in paths.items()}
    fused_entry["note"] = ("the [N, S] counterpart of the Pallas contract; "
                           "no runtime path calls it since the scheduler's "
                           "burst is one fused_burst launch")
    print(f"[total] {time.perf_counter() - t_start:.1f} s from the start of "
          f"main [{card}]")
    print(card)
    print(json.dumps({"kernels": list(entries)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
