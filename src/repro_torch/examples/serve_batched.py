"""Serve a small model with continuous batching, then show the QoS win:
decode collectives sharing one OCCL fabric with an adversarial
background tenant, with preemption ON vs OFF.

Part 1 runs the engine standalone (prefill + step-locked decode over
recycled batch slots).  Part 2 attaches a :class:`ServingQos` fabric:
every decode step issues a tensor-parallel all-reduce while a background
tenant keeps grad-sync bursts at its admission cap -- with preemption the
decode op cuts the burst mid-transfer at slice granularity; without it,
decode waits the whole transfer out.  The before/after p99 (in fabric
supersteps) is the number the serving bench gates on.  Part 3 submits a
decode while a background burst holds the lane.  Port of
``examples/serve_batched.py``.

    python -m repro_torch.examples.serve_batched [--arch llama3-8b] \\
        [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..configs import get_config
from ..core.state import resolve_device
from ..serving import Request, ServingEngine, ServingQos, TrafficClass
from . import arg_parser, fabric_totals

BATCH, PROMPT_LEN = 4, 16
# Part 2's fabric (with preemption on and off) and part 3's.
QOS = dict(n_ranks=4, decode_elems=256, prefill_elems=1024,
           background_elems=4096, background_buckets=2,
           prio_aging_quantum=8)
MID_BURST_QOS = dict(n_ranks=4, decode_elems=256, background_elems=4096,
                     preemption=True)


def requests(n: int, vocab: int, max_new: int, rng) -> list:
    return [Request(rid=i,
                    prompt=rng.randint(0, vocab, size=rng.randint(4, 16)),
                    max_new_tokens=max_new) for i in range(n)]


def parse_args(argv=None):
    ap = arg_parser(__doc__)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=12)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()

    def engine(qos=None):
        """An engine on the seeded requests, run to the end: (engine,
        finished requests, wall seconds)."""
        e = ServingEngine(cfg, batch_size=BATCH, prompt_len=PROMPT_LEN,
                          qos=qos, device=device)
        for r in requests(args.requests, cfg.vocab, args.max_new,
                          np.random.RandomState(0)):
            e.submit(r)
        t0 = time.perf_counter()
        done = e.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        assert e.stats["tokens"] == sum(len(r.out_tokens) for r in done)
        return e, done, wall

    # --- 1. engine alone: continuous batching over recycled slots ------
    e, done, dt = engine()
    for r in done[:4]:
        print(f"req {r.rid}: {len(r.out_tokens)} tokens -> "
              f"{r.out_tokens[:8]}...")
    tok = e.stats["tokens"]
    print(f"{len(done)} requests, {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, {e.stats['prefills']} prefills, "
          f"{e.stats['decode_steps']} decode steps)")
    res = {"alone": dict(e.stats, requests=len(done), wall_s=dt,
                         first_tokens=[r.out_tokens[:8] for r in done[:4]])}

    # --- 2. QoS before/after: decode p99 vs an adversarial tenant ------
    fabrics = []
    for pre in (False, True):
        qos = ServingQos(**QOS, preemption=pre, device=device)
        e, done, wall = engine(qos)   # decode_event pumps the background
        qos.drain()                   # bounded starvation: bursts all land
        bg = qos.tenants[TrafficClass.BACKGROUND]
        res["preempt_on" if pre else "preempt_off"] = {
            "qos": e.stats.pop("qos"), "stats": dict(e.stats),
            "requests": len(done), "wall_s": wall,
            "background": [bg.completed, bg.submitted],
            "ticked": qos.summary()["supersteps"]}
        fabrics.append(qos.runtime.stats())
    off, on = res["preempt_off"]["qos"], res["preempt_on"]["qos"]
    print("decode p99 vs adversarial background "
          "(fabric supersteps per collective):")
    print(f"  preemption OFF: p50 {off['decode']['p50']:.0f}  "
          f"p99 {off['decode']['p99']:.0f}")
    print(f"  preemption ON : p50 {on['decode']['p50']:.0f}  "
          f"p99 {on['decode']['p99']:.0f}")
    for label in ("off", "on"):
        done_, submitted = res[f"preempt_{label}"]["background"]
        print(f"  background ({label}): {done_}/{submitted} "
              "bursts completed after drain (degrades, not starves)")
    assert on["decode"]["p99"] < off["decode"]["p99"]

    # --- 3. the mechanism itself: a decode submit landing MID-burst ----
    # The engine drives the fabric event-wise, so priority ORDERING
    # already wins above; here a burst is mid-transfer on a live daemon
    # when decode arrives, and the slice-granular preempt counter shows
    # the cut.
    qos = ServingQos(**MID_BURST_QOS, device=device)
    qos.submit_background()
    qos.advance(2)              # burst holds the lane mid-superstep
    lat = qos.wait(qos.submit_decode())
    qos.drain()
    res["mid_burst"] = {"latency": lat,
                        "preempts": qos.summary()["preempts"],
                        "supersteps": qos.summary()["supersteps"]}
    fabrics.append(qos.runtime.stats())
    print(f"mid-burst decode: {lat} supersteps, "
          f"preempts {res['mid_burst']['preempts']}")
    assert res["mid_burst"]["preempts"] > 0
    print("OK")
    res["fabric"] = fabric_totals(*fabrics)
    return res


if __name__ == "__main__":
    main()
