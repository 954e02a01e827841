"""Expert-parallel MoE over OCCL: the port (``repro_torch.train.occl_moe``)
against itself and against the reference (``repro.train.occl_moe``).

The reference's parameters are carried across (``models/convert.py``) and
the tokens are seeded numpy.  Tolerances:

* the port's ``OcclMoE.forward`` against the port's ``ep_forward_ref``:
  bit for bit (the all-to-all moves bits; both paths share the per-rank
  stages and the fixed-order combine);
* routing against the reference: the slot tokens ``tok_idx`` and the
  dispatch buffers exactly; the slot weights ``w`` at ``rtol=1e-6`` (the
  router's float32 product and softmax sum in another order in XLA than
  in PyTorch, about one ulp);
* outputs against the reference's ``ep_forward_ref``: ``rtol=1e-5,
  atol=1e-9`` (outputs are about 1e-4; the two differ by float32
  summation order in the products, about 1e-10);
* ``forward_overlapped`` against ``ep_forward_ref``: the same tolerance —
  its batched expert product may sum in another order than the per-rank
  one, so it is not held bitwise (the reference is not bitwise either).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import moe as JM
from repro.train import occl_moe as JO
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.occl_moe import (OcclMoE, _dispatch_local_t,
                                        a2a_exchange_ref, ep_forward_ref)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

R, TL = 4, 8
CLOSE = dict(rtol=1e-5, atol=1e-9)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jget("deepseek-moe-16b").reduced(),
                             capacity_factor=8.0)
    tc = dataclasses.replace(tget("deepseek-moe-16b").reduced(),
                             capacity_factor=8.0)
    jp = JM.init_moe_block(jax.random.PRNGKey(0), "t", jc, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(2)
    xs = [(rng.randn(TL, jc.d_model) * 0.5).astype(np.float32)
          for _ in range(R)]
    return jc, jp, tc, tp, xs


def tensors(xs):
    return [torch.from_numpy(x) for x in xs]


def assert_bitwise(got, want):
    for r in range(R):
        assert torch.equal(got[r], want[r]), r


def test_a2a_exchange_ref_is_personalized():
    c = 3
    ins = [torch.arange(R * c, dtype=torch.float32) + 100 * o
           for o in range(R)]
    out = a2a_exchange_ref(ins)
    for m in range(R):
        want = torch.cat([ins[o][m * c:(m + 1) * c] for o in range(R)])
        assert torch.equal(out[m], want)


@pytest.mark.parametrize("cap", [TL * 2, 4])
def test_routing_matches_reference(setup, cap):
    """Each rank's dispatch: the same slot tokens and dispatch buffer as
    the reference, with and without capacity drops."""
    jc, jp, tc, tp, xs = setup
    for x in xs:
        jxe, jti, jw = JO._dispatch_local_t(jc, jp, jnp.asarray(x), cap)
        txe, tti, tw, _ = _dispatch_local_t(tc, tp, torch.from_numpy(x), cap)
        np.testing.assert_array_equal(tti.numpy(), np.asarray(jti))
        np.testing.assert_array_equal(txe.numpy(), np.asarray(jxe))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("cap", [TL * 2, 4])
def test_ep_ref_matches_reference(setup, cap):
    jc, jp, tc, tp, xs = setup
    want = JO.ep_forward_ref(jc, jp, [jnp.asarray(x) for x in xs], cap=cap)
    got = ep_forward_ref(tc, tp, tensors(xs), cap=cap)
    for r in range(R):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want[r]),
                                   **CLOSE)


@pytest.mark.parametrize("algo,hier", [("ring", None), ("two_level", (2, 2)),
                                       ("auto", None)])
@pytest.mark.parametrize("cap", [TL * 2, 4])
def test_occl_moe_bitwise_matches_ep_ref(setup, algo, hier, cap):
    """cap = T_l * top_k admits no drops; cap = 4 drops real assignments
    (dropped slots travel as zeros on both paths)."""
    _, _, tc, tp, xs = setup
    ref = ep_forward_ref(tc, tp, tensors(xs), cap=cap)
    moe = OcclMoE(tc, R, TL, cap=cap, algo=algo, hierarchy=hier,
                  device="cpu")
    assert_bitwise(moe.forward(tp, tensors(xs)), ref)


def test_ep_ref_matches_dense_oracle(setup):
    """With no-drop capacity the expert-parallel decomposition equals the
    dense every-expert-on-every-token oracle (the reference's tolerance),
    the port's oracle and the reference's alike."""
    jc, jp, tc, tp, xs = setup
    ys = ep_forward_ref(tc, tp, tensors(xs), cap=TL * tc.top_k)
    xg = np.stack(xs).reshape(1, R * TL, tc.d_model)
    want = np.asarray(JM.moe_forward_dense_ref(jc, jp, jnp.asarray(xg)))
    dense = TM.moe_forward_dense_ref(tc, tp, torch.from_numpy(xg))
    np.testing.assert_allclose(dense.numpy(), want, **CLOSE)
    dense = dense.reshape(R, TL, tc.d_model)
    for r in range(R):
        np.testing.assert_allclose(ys[r].numpy(), dense[r].numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_forward_reuses_registrations(setup):
    """Steps resubmit the same two collectives — no re-registration, and
    payload changes flow through (the training-loop usage)."""
    _, _, tc, tp, xs = setup
    cap = TL * tc.top_k
    moe = OcclMoE(tc, R, TL, cap=cap, device="cpu")
    first = moe.forward(tp, tensors(xs))
    xs2 = [x + 1.0 for x in xs]
    second = moe.forward(tp, tensors(xs2))
    assert_bitwise(second, ep_forward_ref(tc, tp, tensors(xs2), cap=cap))
    assert not torch.equal(first[0], second[0])


def test_expert_shard_divisibility_enforced(setup):
    _, _, tc, _, _ = setup
    with pytest.raises(AssertionError, match="n_experts"):
        OcclMoE(tc, 3, TL, device="cpu")      # 8 experts % 3 != 0


def test_forward_overlapped_matches_ref(setup):
    """The stream-sharded overlap path: two shards, the combine of each
    submitted as its FFN finishes, reused across steps; held to the
    reference's outputs and the port's ``ep_forward_ref``."""
    jc, jp, tc, tp, xs = setup
    cap = TL * tc.top_k
    moe = OcclMoE(tc, R, TL, cap=cap, n_streams=2, overlap_ticks=4,
                  device="cpu")
    for shift in (0.0, 1.0):
        xs_s = [x + shift for x in xs]
        s0 = moe.stats()
        ys = moe.forward_overlapped(tp, tensors(xs_s))
        s1 = moe.stats()
        ref = ep_forward_ref(tc, tp, tensors(xs_s), cap=cap)
        want = JO.ep_forward_ref(jc, jp, [jnp.asarray(x) for x in xs_s],
                                 cap=cap)
        for r in range(R):
            np.testing.assert_allclose(ys[r].numpy(), ref[r].numpy(),
                                       **CLOSE)
            np.testing.assert_allclose(ys[r].numpy(), np.asarray(want[r]),
                                       **CLOSE)
        # some supersteps genuinely ran inside the hidden overlap ticks
        assert int(np.max(s1["overlap_supersteps"]
                          - s0["overlap_supersteps"])) > 0
