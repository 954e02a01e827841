"""What the benchmark loads: no JAX and no JAX package anywhere (top-level
names compared whole: the port's name begins with the JAX package's), and
nothing of the port in the reference; and no result without a card."""
import json
import subprocess
import sys

import occl_bench_tiny as tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=tiny.ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{tiny.ROOT / 'src'}:{tiny.ROOT}",
             "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_port_paths_it_drives_load_no_jax():
    top = loaded_after(
        "import occl_bench.harness.cell, occl_bench.harness.standins\n"
        "import occl_bench.drivers.vit_occl_sync, occl_bench.drivers.moe\n"
        "import occl_bench.drivers.vit_overlap\n"
        "import repro_torch.launch.train, repro_torch.train.occl_moe\n"
        "import repro_torch.train.step, repro_torch.train.occl_sync\n"
        "import repro_torch.core.device_api, repro_torch.core.daemon\n"
        "import repro_torch.kernels.fused_slice\n"
        "from occl_bench.harness import cell\n"
        "assert not cell.loaded_forbidden(), cell.loaded_forbidden()")
    assert "repro_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("import occl_bench.reference.vit, "
                       "occl_bench.reference.moe, "
                       "occl_bench.reference.adamw, "
                       "occl_bench.families.vit, "
                       "occl_bench.families.moe, "
                       "occl_bench.roofline.flops, "
                       "occl_bench.roofline.peaks")
    assert not top & (FORBIDDEN | {"repro_torch"}), top


def test_forbidden_names_are_compared_whole():
    from occl_bench.harness import cell

    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro" not in cell.loaded_forbidden() or \
            "repro" in {m.split(".")[0] for m in sys.modules}
    finally:
        del sys.modules["repro_torch_lookalike"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "occl_bench/run.py", "--workload",
         "vit-base-dp4.occl-sync", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
