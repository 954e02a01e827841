"""Tiny versions of the benchmark's configurations and cells, for CPU
tests: the same files with the widths, batch and runtime cut so that a
cell's whole run takes seconds on the CPU."""
from __future__ import annotations

import copy
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

VIT_CELLS = ("vit-base-dp4.occl-sync", "vit-base-dp4.overlap")
MOE_CELLS = ("deepseek-moe-16b-ep4.overlap", "deepseek-moe-16b-ep4.barrier")


def _load(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def config(name: str) -> dict:
    cfg = copy.deepcopy(_load(f"configs/{name}.json"))
    if cfg["family"] == "vit":
        cfg.update(hidden_size=64, num_attention_heads=2, head_dim=32,
                   intermediate_size=128, num_patches=16, num_labels=10)
        cfg["port"]["overrides"].update(
            d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
            vocab=10, vis_tokens=16)
        cfg["deployment"].update(global_batch=8, bucket_elems=1 << 16,
                                 slice_elems=2048, burst_slices=1)
        # float32 products, so a sound tiny run reads rounding alone
        cfg["port"]["overrides"]["compute_dtype"] = "float32"
    else:
        cfg.update(hidden_size=64, n_routed_experts=8, num_experts_per_tok=2,
                   n_shared_experts=1, moe_intermediate_size=32)
        cfg["port"]["overrides"].update(d_model=64, n_experts=8, top_k=2,
                                        n_shared_experts=1, d_ff_expert=32)
        cfg["deployment"].update(tokens_per_rank=16, slice_elems=512,
                                 n_streams=2, overlap_ticks=4)
    return cfg


def workload(name: str) -> dict:
    wl = copy.deepcopy(_load(f"workloads/{name}.json"))
    if "drain_iters" in wl:
        wl["drain_iters"] = 1024
    if wl["driver"] == "moe" and wl["mode"] == "overlap":
        wl["warm_ticks"] = [4, 8, 16]
    return wl


def run(name: str, seed: int = 7, seconds: float = 0.0, trace=False,
        metrics=()):
    """The cell's whole run on the CPU (no look for a card)."""
    import time

    import torch
    from occl_bench.harness import cell

    torch.set_num_threads(1)
    wl = workload(name)
    return cell.run(config(wl["config"]), wl, seed, seconds, "cpu",
                    time.perf_counter(), metrics, trace,
                    log=lambda msg: None)
