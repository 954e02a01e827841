"""``launch/serve.py --qos`` and ``launch/train.py --reduced`` on the
hybrid, vlm and encdec archs against the reference's launchers.

The serving printout equals the reference's, wall-clock figures aside (the
counts and the QoS digest are structural).  ``launch/train.py`` runs from
the reference's initial state (carried across with ``models/convert.py``):
the same parameter count line and steps, the losses within ``rtol=2e-4``
(the bfloat16 loss tolerance of ``tests/test_torch_models.py``).
"""
import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("zamba2-1.2b", "paligemma-3b", "seamless-m4t-large-v2")


def untimed(text: str) -> str:
    return re.sub(r" in [0-9.]+s \([0-9.]+ tok/s\)", "", text)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_matches_reference(monkeypatch, arch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--arch", arch, "--requests", "3", "--max-new", "4", "--batch",
            "2", "--qos"]
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jserve.main()
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        stats = tserve.main(args + ["--device", "cpu"])
    assert untimed(tout.getvalue()) == untimed(jout.getvalue())
    assert f"{arch}: 3 requests, 12 tokens" in tout.getvalue()
    assert stats["tokens"] == 12 and "qos" in stats


def test_launch_train_matches_reference(monkeypatch, tmp_path):
    """``launch/train.py --arch zamba2-1.2b --reduced`` on both packages
    from the reference's initial state: the same parameter count line and
    steps, the losses within ``rtol=2e-4``."""
    from repro.launch import train as jtrain
    from repro.train.state import init_state as jinit
    from repro_torch.launch import train as ttrain
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train import state as tstate

    args = ["--arch", "zamba2-1.2b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "16", "--ckpt-period", "100"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "ref")])
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jtrain.main()
    js = jinit(jget("zamba2-1.2b").reduced())
    own = tstate.init_state
    monkeypatch.setattr(tstate, "init_state", lambda cfg, device=None: (
        own(cfg, device=device) if str(device) == "meta" else
        train_state_from_numpy(*(jax.tree_util.tree_map(np.asarray, x)
                                 for x in js), device=device)))
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        ctrl = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    jlines, tlines = jout.getvalue().splitlines(), tout.getvalue().splitlines()
    assert tlines[0] == jlines[0] and tlines[0].startswith(
        "arch=zamba2-1.2b params=")
    loss = lambda lines: [float(m.group(1)) for m in (
        re.match(r"step +\d+ loss ([0-9.]+)", x) for x in lines) if m]
    assert len(loss(tlines)) == len(loss(jlines)) == 3
    np.testing.assert_allclose(loss(tlines), loss(jlines), rtol=2e-4)
    assert [m["step"] for m in ctrl.metrics_log] == [0, 1, 2]
