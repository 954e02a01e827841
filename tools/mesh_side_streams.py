"""The mesh backend's side streams on and off, in turns, on one CUDA card.

    python3 tools/mesh_side_streams.py [--rounds 2]

Runs ``chip_smoke.py``'s real-size mesh cell (R=8 ranks on one card, slice
1024, K=32, B=8, two 2^20 f32 all-reduces per rank in opposite orders, one
iteration) with the mesh's side streams off and on in turns (off, on, on,
off per round), holding each run's outputs bit-equal to the sim backend's
on the same workload.  "Off" clears the built runtime's
``MeshTicker.streams`` before the drive, so that every rank's work is
issued on the one current stream.  Prints the card's name and power limit,
one line per run (wall ms per superstep), and a JSON summary.  Fails
without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def one_stream(make_rt, off: bool):
    """``make_rt`` whose runtimes, when ``off``, issue every rank's work on
    the current stream: the drive builds the MeshTicker, then clears its
    side streams before the first chunk is captured."""
    def make(kw):
        rt = make_rt(kw)
        if off:
            drive = rt.drive

            def drive_on_one_stream(*a, **k):
                rt._ensure_built()
                rt._ticker.streams = None
                return drive(*a, **k)
            rt.drive = drive_on_one_stream
        return rt
    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mesh_side_streams: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch import core
    from repro_torch.kernels import _build, fused_slice

    _build.build_all([fused_slice.LIBRARY])
    device = torch.device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    sim = cs.mesh_real(core, cs.mesh_maker(core, device), card, "sim")

    runs = {False: [], True: []}
    for _ in range(args.rounds):
        for flag in (False, True, True, False):
            res = cs.mesh_real(core, one_stream(cs.mesh_maker(
                core, device, [device] * 8), not flag), card,
                f"mesh, side streams {'on' if flag else 'off'}")
            for k, v in res["outputs"].items():
                assert v.tobytes() == sim["outputs"][k].tobytes(), k
            assert res["supersteps"] == sim["supersteps"]
            runs[flag].append(res["wall_ms_per_superstep"])
            del res
            cs.free_card()
    print(json.dumps({"card": card, "sim_ms": sim["wall_ms_per_superstep"],
                      "side_streams_off_ms": runs[False],
                      "side_streams_on_ms": runs[True]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
