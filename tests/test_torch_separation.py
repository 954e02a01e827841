"""The port stands alone: importing every module of ``repro_torch`` (the
examples included) imports neither ``jax`` nor the reference package
``repro``.  Checked in a fresh interpreter, since the test process itself
imports both."""
import os
import subprocess
import sys

from torch_parity import ROOT

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "repro_torch.examples.train_dp_occl" in names, leaked)
"""


def test_port_imports_neither_jax_nor_the_reference():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    n, has_examples, leaked = out.stdout.split(maxsplit=2)
    assert int(n) > 70 and has_examples == "True", out.stdout
    assert leaked.strip() == "[]", leaked
