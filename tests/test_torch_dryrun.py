"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's.

Each plan runs in a subprocess: the planning mesh's fake process group is
global to its process.  The port's plan of qwen3-0.6b ``train_4k`` on the
16x16 mesh gives the reference compile's per-device argument bytes
(``memory_analysis().argument_size_in_bytes``, 212271108) and its
parameter, FLOP and token counts.  One plan per family at full width and
reduced depth completes, records collectives, counts at least the model's
FLOPs (6 x active parameters x tokens; for ViT the tokens it sees,
``vis_tokens`` per sample, where the reference's ``model_tokens`` counts
``seq_len``) and lays out exactly the bytes the specs reckon.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

from repro_torch.launch import dryrun
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
KEYS = ("mem_argument_bytes", "n_params_matmul", "n_params_active",
        "model_flops_global", "model_tokens")


def run(script: str, timeout: int = 600) -> dict:
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=timeout, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


_REFERENCE = textwrap.dedent("""
    import sys
    sys.path.insert(0, @SRC@)
    import repro.launch.dryrun as R      # sets XLA_FLAGS before jax starts
    import json
    res = R.run_cell("qwen3-0.6b", "train_4k", False, None,
                     with_roofline=False)
    print("RESULT " + json.dumps({k: res[k] for k in @KEYS@}))
""").replace("@SRC@", repr(SRC)).replace("@KEYS@", repr(KEYS))

_PORT = textwrap.dedent("""
    import sys
    sys.path.insert(0, @SRC@)
    import json
    from repro_torch.launch.dryrun import run_cell
    res = run_cell("qwen3-0.6b", "train_4k", False, None)
    print("RESULT " + json.dumps(res))
""").replace("@SRC@", repr(SRC))


def test_qwen3_train_plan_matches_reference_compile():
    want = run(_REFERENCE)
    got = run(_PORT)
    assert want["mem_argument_bytes"] == 212271108
    for k in KEYS:
        assert got[k] == want[k], k
    assert got["compile_ok"] and got["mesh"] == "16x16"
    assert got["roofline"]["probe_layers"] == "full"
    assert got["rolled"]["flops"] >= got["model_flops_global"]
    assert got["rolled"]["collectives"]


# One arch per family, full width, depth cut to 2 layers (the hybrid's to
# one application of its shared block, the encoder's to 2).
FAMILIES = {"dense": "llama3-8b", "moe": "deepseek-moe-16b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-1.2b",
            "vlm": "paligemma-3b", "encdec": "seamless-m4t-large-v2",
            "vit": "vit-base"}

_FAMILY_PLANS = textwrap.dedent("""
    import sys
    sys.path.insert(0, @SRC@)
    import dataclasses, json
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import (active_params, plan_cell,
                                           spec_argument_bytes)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model

    mesh = make_production_mesh()
    out = {}
    for fam, arch in @FAMILIES@.items():
        cfg = get_config(arch)
        cut = {"n_layers": cfg.shared_attn_period or 2}
        if cfg.enc_layers:
            cut["enc_layers"] = 2
        cfg = dataclasses.replace(cfg, **cut)
        cell = SHAPES["train_4k"]
        plan = plan_cell(cfg, cell, mesh)
        _, active = active_params(cfg, build_model(cfg).init(0, "meta"))
        # The reference counts global_batch * seq_len model tokens for
        # every family; ViT sees vis_tokens per sample, whatever seq_len.
        tokens = cell.global_batch * cfg.vis_tokens if fam == "vit" \
            else plan["model_tokens"]
        out[fam] = dict(plan, model_flops=6 * active * tokens,
                        spec_bytes=spec_argument_bytes(cfg, cell, mesh))
    print("RESULT " + json.dumps(out))
""").replace("@SRC@", repr(SRC)).replace("@FAMILIES@", repr(FAMILIES))


def test_one_plan_per_family():
    plans = run(_FAMILY_PLANS)
    assert plans.keys() == FAMILIES.keys()
    for fam, p in plans.items():
        assert p["cost"]["collectives"], fam
        assert sum(c["count"] for c in p["cost"]["collectives"].values()) > 0
        assert p["cost"]["flops"] >= p["model_flops"] > 0, fam
        assert p["mem_argument_bytes"] == p["spec_bytes"], fam
        assert 0 < p["cost"]["flops_per_device"] < p["cost"]["flops"], fam


def test_results_go_to_the_ports_own_directory():
    path = dryrun._cell_path("llama3-8b", "train_4k", True)
    assert path == ROOT / "dryrun_results_torch" / \
        "llama3-8b__train_4k__2x16x16.json"
    assert "benchmarks" not in path.parts
