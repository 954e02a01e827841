"""Whole runs of each cell at a small size on the CPU, past the harness's
look for a card: sound runs come out correct; the control (the reference
one precision below the configuration's, in the program's place) and each
fault a cell can have, planted under the timed path, come out not correct.

Faults: a step that returns its state unchanged (training cells only: a
MoE forward keeps no state), half of each rank's batch left out with the
mean taken over the rest, the exchange between ranks left out, and an
answer altered where it is produced.
"""
import numpy as np
import pytest
import torch

import occl_bench_tiny as tiny
from occl_bench.harness import compare, standins

VIT_FAULTS = ("unchanged", "half_batch", "no_exchange", "answer_altered")
MOE_FAULTS = ("half_batch", "no_exchange", "answer_altered")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plant_vit(mp, fault: str, cell: str) -> None:
    import repro_torch.train.step as step_mod
    from repro_torch.core.device_api import DeviceApi
    from repro_torch.core.runtime import OcclRuntime
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.tree import tree_map

    if fault == "unchanged":
        mp.setattr(step_mod, "make_apply_step",
                   lambda cfg, opt=None: (lambda state, grads: state))
    elif fault == "half_batch":
        real = step_mod.as_batch
        mp.setattr(step_mod, "as_batch", lambda b, dev: {
            k: v[: v.shape[0] // 2] for k, v in real(b, dev).items()})
    elif fault == "no_exchange" and cell.endswith("occl-sync"):
        mp.setattr(OcclGradSync, "all_reduce", lambda self, per_rank: [
            tree_map(lambda g: g.float(), g) for g in per_rank])
    elif fault == "no_exchange":
        def own(self, st, rank, coll_id):
            lo = self._specs[coll_id].in_off
            span = int(self._t.in_span[coll_id])
            x = st.heap_in[rank, lo:lo + span]
            m = self._in_map(coll_id)
            return (x if m is None else x[m]) * self.cfg.n_ranks
        mp.setattr(DeviceApi, "read", own)
    elif fault == "answer_altered" and cell.endswith("occl-sync"):
        real = OcclRuntime.read_outputs_bulk

        def altered(self, reads):
            out = real(self, reads)
            key = tuple(reads[0][:2])
            out[key][: self.cfg.slice_elems] *= self.cfg.n_ranks
            return out
        mp.setattr(OcclRuntime, "read_outputs_bulk", altered)
    elif fault == "answer_altered":
        real = DeviceApi.read

        def altered(self, st, rank, coll_id):
            x = real(self, st, rank, coll_id)
            if rank == 0:
                x = x.clone()
                x[: self.cfg.slice_elems] *= self.cfg.n_ranks
            return x
        mp.setattr(DeviceApi, "read", altered)


def plant_moe(mp, fault: str, cell: str) -> None:
    import repro_torch.train.occl_moe as moe_mod
    from repro_torch.core.device_api import DeviceApi
    from repro_torch.core.runtime import OcclRuntime

    if fault == "half_batch":
        real = moe_mod.OcclMoE._tokens

        def half(self, xs):
            out = []
            for x in real(self, xs):
                x = x.clone()
                x[x.shape[0] // 2:] = 0.0
                out.append(x)
            return out
        mp.setattr(moe_mod.OcclMoE, "_tokens", half)
    elif fault == "no_exchange" and cell.endswith("barrier"):
        sent = {}
        real_submit = OcclRuntime.submit

        def submit(self, rank, coll_id, prio=0, data=None, **kw):
            sent[(rank, coll_id)] = np.array(data, copy=True)
            return real_submit(self, rank, coll_id, prio, data, **kw)
        mp.setattr(OcclRuntime, "submit", submit)
        mp.setattr(OcclRuntime, "read_outputs_bulk", lambda self, reads: {
            tuple(r[:2]): sent[tuple(r[:2])].copy() for r in reads})
    elif fault == "no_exchange":
        sent = {}
        real_submit = DeviceApi.submit_all

        def submit_all(self, st, coll_id, data, prio=0):
            sent[coll_id] = data.clone()
            return real_submit(self, st, coll_id, data, prio)
        mp.setattr(DeviceApi, "submit_all", submit_all)
        mp.setattr(DeviceApi, "read_all",
                   lambda self, st, coll_id: sent[coll_id])
    elif fault == "answer_altered":
        real = moe_mod._combine_local

        def altered(*a):
            y = real(*a).clone()
            y[0, 0] += 1.0
            return y
        mp.setattr(moe_mod, "_combine_local", altered)


@pytest.mark.parametrize("cell", tiny.VIT_CELLS + tiny.MOE_CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["step_s"] > 0


@pytest.mark.parametrize("cell", tiny.VIT_CELLS)
def test_training_window_holds_the_checked_steps(cell):
    from occl_bench.harness import drivers

    res = tiny.run(cell)
    # the window's first steps are among those the reference follows
    assert res["attempted"] == drivers.CHECKED_STEPS - drivers.WARM_STEPS
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in tiny.VIT_CELLS for f in VIT_FAULTS]
                         + [(c, f) for c in tiny.MOE_CELLS
                            for f in MOE_FAULTS])
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    plant = plant_vit if cell in tiny.VIT_CELLS else plant_moe
    plant(monkeypatch, fault, cell)
    res = tiny.run(cell)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", [tiny.VIT_CELLS[0], tiny.MOE_CELLS[0]])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_is_not_correct(cell, seed):
    wl = tiny.workload(cell)
    cfg = tiny.config(wl["config"])
    readings = standins.read(cfg, wl, seed, "cpu", "control")
    ok, checks = compare.judge(readings, wl["limits"])
    assert not ok, checks
