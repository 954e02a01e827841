"""Faults under ``drivers/vit_occl_sync.py``: a step that returns its state
unchanged, half of each rank's batch left out with the mean taken over the
rest, the exchange between ranks left out (each rank keeps its own
gradient), and a reduced answer altered where it is read back."""


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
    from repro_torch.train.occl_sync import OcclGradSync
    from repro_torch.tree import tree_map

    mp.setattr(OcclGradSync, "all_reduce", lambda self, per_rank: [
        tree_map(lambda g: g.float(), g) for g in per_rank])


def answer_altered(mp, wl) -> None:
    from repro_torch.core.runtime import OcclRuntime

    real = OcclRuntime.read_outputs_bulk

    def altered(self, reads):
        out = real(self, reads)
        key = tuple(reads[0][:2])
        out[key][: self.cfg.slice_elems] *= self.cfg.n_ranks
        return out
    mp.setattr(OcclRuntime, "read_outputs_bulk", altered)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "answer_altered": answer_altered}
