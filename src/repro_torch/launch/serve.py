"""Serving launcher (PyTorch port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --requests 8 --max-new 16 [--qos] [--device cpu]

With ``--qos`` the engine's prefill/decode collectives run as staged
OCCL submits on a shared fabric alongside an adversarial background
tenant (grad-sync bursts at the admission cap); decode preempts the
bursts mid-superstep unless ``--no-preempt`` selects the FIFO baseline.
The run then prints the per-class latency digest (supersteps).

It runs the ``.reduced()`` configs, as the reference does; the engine and
the fabric run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--qos", action="store_true",
                    help="share an OCCL fabric with a background tenant")
    ap.add_argument("--no-preempt", action="store_true",
                    help="QoS baseline: FIFO, no priority preemption")
    ap.add_argument("--tp-ranks", type=int, default=4,
                    help="fabric size for the QoS collectives")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serve ``--requests`` seeded requests; returns the engine's stats
    (with the post-drain QoS digest under ``"qos"`` when ``--qos``)."""
    args = parse_args(argv)
    from ..configs import get_config
    from ..core.state import resolve_device
    from ..serving.engine import Request, ServingEngine

    device = resolve_device(args.device)
    qos = None
    if args.qos:
        from ..serving.qos import ServingQos
        qos = ServingQos(n_ranks=args.tp_ranks,
                         preemption=not args.no_preempt,
                         prio_aging_quantum=8, device=device)

    cfg = get_config(args.arch).reduced()
    eng = ServingEngine(cfg, batch_size=args.batch,
                        prompt_len=args.prompt_len,
                        max_len=args.prompt_len + args.max_new + 8,
                        qos=qos, device=device)
    rng = np.random.RandomState(0)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i, prompt=rng.randint(0, cfg.vocab,
                                      size=rng.randint(4, args.prompt_len)),
            max_new_tokens=args.max_new))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    print(f"{args.arch}: {len(done)} requests, "
          f"{eng.stats['tokens']} tokens in {dt:.2f}s "
          f"({eng.stats['tokens']/dt:.1f} tok/s)")
    if qos is not None:
        qos.drain()             # bounded starvation: bursts all land
        q = qos.summary()       # post-drain digest
        eng.stats["qos"] = q
        print(f"qos (preemption={'off' if args.no_preempt else 'on'}): "
              f"decode p50 {q['decode']['p50']:.0f} / "
              f"p99 {q['decode']['p99']:.0f} supersteps, "
              f"prefill p99 {q['prefill']['p99']:.0f}, "
              f"background completed {q['background']['completed']}"
              f"/{q['background']['submitted']}, "
              f"preempts {q['preempts']}")
    return eng.stats


if __name__ == "__main__":
    main()
