"""Faults under ``drivers/vit_overlap.py``: a step that returns its state
unchanged, half of each rank's batch left out, the exchange left out (each
rank reads its own input back, times the rank count) and a reduced answer
altered where the in-step API reads it."""


def unchanged(mp, wl) -> None:
    import repro_torch.train.step as step_mod

    mp.setattr(step_mod, "make_apply_step",
               lambda cfg, opt=None: (lambda state, grads: state))


def half_batch(mp, wl) -> None:
    import repro_torch.train.step as step_mod

    real = step_mod.as_batch
    mp.setattr(step_mod, "as_batch", lambda b, dev: {
        k: v[: v.shape[0] // 2] for k, v in real(b, dev).items()})


def no_exchange(mp, wl) -> None:
    from repro_torch.core.device_api import DeviceApi

    def own(self, st, rank, coll_id):
        lo = self._specs[coll_id].in_off
        span = int(self._t.in_span[coll_id])
        x = st.heap_in[rank, lo:lo + span]
        m = self._in_map(coll_id)
        return (x if m is None else x[m]) * self.cfg.n_ranks
    mp.setattr(DeviceApi, "read", own)


def answer_altered(mp, wl) -> None:
    from repro_torch.core.device_api import DeviceApi

    real = DeviceApi.read

    def altered(self, st, rank, coll_id):
        x = real(self, st, rank, coll_id)
        if rank == 0:
            x = x.clone()
            x[: self.cfg.slice_elems] *= self.cfg.n_ranks
        return x
    mp.setattr(DeviceApi, "read", altered)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "answer_altered": answer_altered}
