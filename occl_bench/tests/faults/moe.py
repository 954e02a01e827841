"""Faults under ``drivers/moe.py`` (a forward keeps no state, so no
unchanged-state fault): half of each rank's tokens zeroed, the exchange
left out (each rank reads back what it sent: through the host in
``barrier`` mode, through the in-step API in ``overlap``), and one output
element altered where the combine produces it."""
import numpy as np


def half_batch(mp, wl) -> None:
    import repro_torch.train.occl_moe as moe_mod

    real = moe_mod.OcclMoE._tokens

    def half(self, xs):
        out = []
        for x in real(self, xs):
            x = x.clone()
            x[x.shape[0] // 2:] = 0.0
            out.append(x)
        return out
    mp.setattr(moe_mod.OcclMoE, "_tokens", half)


def no_exchange(mp, wl) -> None:
    from repro_torch.core.device_api import DeviceApi
    from repro_torch.core.runtime import OcclRuntime

    sent = {}
    if wl["mode"] == "barrier":
        real_submit = OcclRuntime.submit

        def submit(self, rank, coll_id, prio=0, data=None, **kw):
            sent[(rank, coll_id)] = np.array(data, copy=True)
            return real_submit(self, rank, coll_id, prio, data, **kw)
        mp.setattr(OcclRuntime, "submit", submit)
        mp.setattr(OcclRuntime, "read_outputs_bulk", lambda self, reads: {
            tuple(r[:2]): sent[tuple(r[:2])].copy() for r in reads})
        return
    real_submit_all = DeviceApi.submit_all

    def submit_all(self, st, coll_id, data, prio=0):
        sent[coll_id] = data.clone()
        return real_submit_all(self, st, coll_id, data, prio)
    mp.setattr(DeviceApi, "submit_all", submit_all)
    mp.setattr(DeviceApi, "read_all", lambda self, st, coll_id: sent[coll_id])


def answer_altered(mp, wl) -> None:
    import repro_torch.train.occl_moe as moe_mod

    real = moe_mod._combine_local

    def altered(*a):
        y = real(*a).clone()
        y[0, 0] += 1.0
        return y
    mp.setattr(moe_mod, "_combine_local", altered)


FAULTS = {"half_batch": half_batch, "no_exchange": no_exchange,
          "answer_altered": answer_altered}
