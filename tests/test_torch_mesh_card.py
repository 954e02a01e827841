"""The mesh backend over two devices on the card: ranks 0-3 on ``cuda``,
ranks 4-7 on ``cpu``.  The ticker runs eagerly, each exchange permute and
each vote copying between the card and the host; the CUDA ranks launch
``fused_burst``, the CPU ranks take its plain version.  Outputs and every
counter equal the sim backend's on the card, and the counts the
reference's mesh's (``chip_smoke.MESH_REF``).

Needs a CUDA card (marker ``card``; skipped without one).  Run it with

    PYTHONPATH=src python -m pytest -m card tests/test_torch_mesh_card.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = [pytest.mark.card, pytest.mark.filterwarnings(
    "ignore::repro_torch.core.errors.ConnDepthWarning")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("name", list(CS.MESH_WORKLOADS))
def test_mesh_over_cuda_and_cpu_equals_sim(card, name):
    import repro_torch.core as T
    from repro_torch.kernels import fused_slice

    two = [card] * 4 + [torch.device("cpu")] * 4
    fused_slice.fused_burst.launches = 0
    rts, outs = CS.MESH_WORKLOADS[name](T, CS.mesh_maker(T, card, two))
    launches = fused_slice.fused_burst.launches
    for rt in rts.values():
        assert rt._ticker.multi and not rt._ticker.graphed
    counts = CS.mesh_counts(rts)
    summary = CS.mesh_summary(counts)
    assert summary == CS.MESH_REF[name]
    # The four CUDA ranks launch the kernel once each per superstep.
    assert launches >= 4 * sum(s for s, _, _ in summary.values())
    srts, souts = CS.MESH_WORKLOADS[name](T, CS.mesh_maker(T, card))
    for k, v in outs.items():
        assert (np.asarray(v, np.float32).tobytes()
                == np.asarray(souts[k], np.float32).tobytes()), k
    for tag, c in CS.mesh_counts(srts).items():
        for k in CS.MESH_COUNTERS[:-1]:
            np.testing.assert_array_equal(c[k], counts[tag][k],
                                          err_msg=(tag, k))
