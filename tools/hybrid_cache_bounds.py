"""CPU runs behind ``chip_smoke.py``'s ``HYBRID_CACHE_REL_L2`` (phase 7k).

    PYTHONPATH=src python tools/hybrid_cache_bounds.py [--widths 256 512]

Runs ``chip_smoke.cache_check`` on Zamba2-1.2B at its full depth (38
Mamba2 layers, the shared block applied 6 times) and narrower widths:
d_model D, D / 64 attention heads of 64 (as many KV heads), d_ff 4 D, the
ssm widths that follow from D (headdim 64, state 64, 2 groups, chunk 256).
Two prompts: a prefill of 256 tokens then 256 decode steps against a
prefill of 512, in bfloat16 and, on the same parameters, in float32.
Prints one JSON line per width and dtype with the relative L2 of the last
logits and of every cache leaf.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
THREADS = 4        # CPU threads: the runs share the machine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=[256, 512, 1024])
    args = ap.parse_args(argv)
    torch.set_num_threads(THREADS)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    full = get_config(cs.HYBRID_SERVE["arch"])
    n_pre = cs.HYBRID_SERVE["check_prefill"]
    n_dec = cs.HYBRID_SERVE["check_decode"]
    for D in args.widths:
        cfg = dataclasses.replace(full, d_model=D, n_heads=D // 64,
                                  n_kv_heads=D // 64, d_ff=4 * D)
        params = build_model(cfg).init(0, "cpu")
        g = torch.Generator().manual_seed(cs.HYBRID_SERVE["seed"])
        toks = torch.randint(0, cfg.vocab, (2, n_pre + n_dec), generator=g,
                             dtype=torch.int32)
        for dt in (cfg.compute_dtype, "float32"):
            c = dataclasses.replace(cfg, compute_dtype=dt)
            p = tree_map(lambda a: a.to(getattr(torch, dt)), params)
            t0 = time.perf_counter()
            res = cs.cache_check(build_model(c), p, toks, n_pre + n_dec,
                                 n_dec)
            print(json.dumps({"d_model": D, "n_layers": cfg.n_layers,
                              "dtype": dt, "s": time.perf_counter() - t0,
                              **res}), flush=True)


if __name__ == "__main__":
    main()
