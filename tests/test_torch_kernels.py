"""Port kernel modules: the plain PyTorch versions of ``fused_primitive``
and ``chunk_combine`` against the reference Pallas kernels (interpret mode)
and the reference oracles (``ref.fused_primitive_ref``,
``ref.chunk_combine_ref``), bit for bit.

The CUDA kernels themselves run only on the card (they have no CPU mode);
``chip_smoke.py`` holds them bitwise against these same plain versions
there, at the main path's shapes, NaN and inf entries included.  Here the
wrappers take the plain versions because the tensors lie on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.chunk_combine import chunk_combine_pallas
from repro.kernels.fused_slice import fused_primitive_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels.chunk_combine import (chunk_combine,
                                               chunk_combine_plain)
from repro_torch.kernels.fused_slice import (fused_primitive,
                                             fused_primitive_plain)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, n, s, dtype):
    """Identical bits for both packages: values rounded once by JAX, then
    carried into torch as raw bit patterns."""
    jd, td = DTYPES[dtype]
    p = jnp.asarray(rng.randn(n, s).astype(np.float32), jd)
    l = jnp.asarray(rng.randn(n, s).astype(np.float32), jd)
    return p, l, _to_torch(p, td), _to_torch(l, td)


def _to_torch(a, td):
    a = np.asarray(a)
    if td == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _nan(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return torch.isnan(a.float()).numpy()
    return np.isnan(np.asarray(a, np.float32))


def _assert_bitwise(got, want):
    """Bitwise equal, NaN compared as "both NaN" (payload bits may differ)."""
    gn, wn = _nan(got), _nan(want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(_bits(got)[~gn], _bits(want)[~wn])


def _check(p, l, tp, tl, flags):
    got = fused_primitive(tp, tl, torch.from_numpy(flags))
    jf = jnp.asarray(flags)
    _assert_bitwise(got, fused_primitive_pallas(p, l, jf, interpret=True))
    # ref.fused_primitive_ref does not clip ``op`` (an out-of-range op is
    # a product there, while the kernel and the scheduler clip to 0..3),
    # so it is the oracle for in-range ops only.
    rows = (flags[:, 3] >= 0) & (flags[:, 3] <= 3)
    _assert_bitwise(got[torch.from_numpy(rows)],
                    np.asarray(jref.fused_primitive_ref(p, l, jf))[rows])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 8), (1, 64), (3, 512), (2, 1024),
                                 (4, 96)])
def test_plain_matches_pallas_and_ref_sweep(dtype, B, S):
    rng = np.random.RandomState(B * 1000 + S)
    p, l, tp, tl = _inputs(rng, B, S, dtype)
    f = rng.randint(0, 2, (B, 4)).astype(np.int32)
    f[:, 3] = rng.randint(0, 4, (B,))
    _check(p, l, tp, tl, f)


def _all_patterns() -> np.ndarray:
    """All 16 (recv, reduce, reads_in, 4th bit) flag patterns x 4 ops, plus
    out-of-range ops that clip to 0..3: [64 + 4, 4] int32."""
    i = np.arange(64)
    f = np.stack([i & 1, (i >> 1) & 1, (i >> 2) & 1, (i >> 4) % 4], axis=1)
    f[:, 0] += (i >> 3) & 1            # the 4th pattern bit: recv value 2
    extra = np.array([[1, 1, 0, -3], [0, 1, 1, 7], [1, 1, 1, 4],
                      [0, 1, 0, -1]])
    return np.concatenate([f, extra]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 96])
def test_all_flag_patterns_and_ops(dtype, S):
    flags = _all_patterns()
    rng = np.random.RandomState(S)
    p, l, tp, tl = _inputs(rng, flags.shape[0], S, dtype)
    _check(p, l, tp, tl, flags)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_and_inf_propagate_like_jnp(dtype):
    """max/min propagate NaN (jnp.maximum / jnp.minimum semantics); +/-inf
    and NaN flow through every op and pass-through branch unchanged."""
    flags = _all_patterns()
    n, S = flags.shape[0], 32
    rng = np.random.RandomState(3)
    pv = rng.randn(n, S).astype(np.float32)
    lv = rng.randn(n, S).astype(np.float32)
    pv[:, 0::4] = np.nan
    lv[:, 1::4] = np.nan
    pv[:, 2::8] = np.inf
    lv[:, 2::8] = -np.inf
    lv[:, 3::8] = np.inf
    pv[:, 6::8] = -np.inf
    jd, td = DTYPES[dtype]
    p, l = jnp.asarray(pv, jd), jnp.asarray(lv, jd)
    _check(p, l, _to_torch(p, td), _to_torch(l, td), flags)


def test_dispatch_routes_cpu_tensors_to_plain_version():
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.randn(6, 16).astype(np.float32))
    l = torch.from_numpy(rng.randn(6, 16).astype(np.float32))
    f = torch.from_numpy(_all_patterns()[:6])
    before = fused_primitive.launches
    got = tops.fused_primitive_batch(p, l, f)
    assert torch.equal(got, fused_primitive_plain(p, l, f))
    assert torch.equal(got, tops.fused_primitive_ref(p, l, f))
    assert fused_primitive.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["noncontig", "dtype", "mixed", "flags",
                                 "shape", "float64"])
def test_wrapper_refuses_bad_inputs(bad):
    p = torch.zeros(4, 8)
    l = torch.zeros(4, 8)
    f = torch.zeros(4, 4, dtype=torch.int32)
    if bad == "noncontig":
        p = torch.zeros(8, 4).t()
    elif bad == "dtype":
        p, l = p.to(torch.int32), l.to(torch.int32)
    elif bad == "mixed":
        l = l.to(torch.bfloat16)
    elif bad == "flags":
        f = f.to(torch.int64)
    elif bad == "shape":
        f = torch.zeros(3, 4, dtype=torch.int32)
    elif bad == "float64":
        p, l = p.double(), l.double()
    with pytest.raises((TypeError, ValueError)):
        fused_primitive(p, l, f)


# ---------------------------------------------------------------------------
# chunk_combine
# ---------------------------------------------------------------------------

def _combine_check(a, b, op, td):
    got = chunk_combine(_to_torch(a, td), _to_torch(b, td), op)
    _assert_bitwise(got, chunk_combine_pallas(a, b, op, interpret=True))
    _assert_bitwise(got, np.asarray(jref.chunk_combine_ref(a, b, op)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [8, 1000, 1024, 4096, 5000])
@pytest.mark.parametrize("op", [0, 1, 2, 3])
def test_chunk_combine_plain_matches_pallas_sweep(dtype, T, op):
    """``tests/test_kernels.py``'s chunk_combine sweep, bitwise against
    the Pallas kernel in interpret mode and the reference oracle."""
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(T + op)
    a = jnp.asarray(rng.randn(T), jd)
    b = jnp.asarray(rng.randn(T), jd)
    _combine_check(a, b, op, td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", [0, 1, 2, 3])
def test_chunk_combine_nan_and_inf_like_jnp(dtype, op):
    """NaN propagates through max/min as in jnp.maximum / jnp.minimum;
    +/-inf and NaN flow through sum and product (inf - inf is NaN)."""
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(11 + op)
    av = rng.randn(1000).astype(np.float32)
    bv = rng.randn(1000).astype(np.float32)
    av[0::7] = np.nan
    bv[3::11] = np.nan
    av[1::13] = np.inf
    bv[1::13] = -np.inf
    bv[5::17] = np.inf
    av[6::19] = -np.inf
    _combine_check(jnp.asarray(av, jd), jnp.asarray(bv, jd), op, td)


def test_chunk_combine_dispatch_routes_cpu_tensors_to_plain_version():
    a = torch.randn(100)
    b = torch.randn(100)
    before = chunk_combine.launches
    for op in range(4):
        got = tops.chunk_combine(a, b, op)
        assert torch.equal(got, chunk_combine_plain(a, b, op))
        assert torch.equal(got, tops.chunk_combine_ref(a, b, op))
    assert chunk_combine.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("bad", ["noncontig", "dtype", "mixed", "shape",
                                 "2d", "op"])
def test_chunk_combine_refuses_bad_inputs(bad):
    a, b, op = torch.zeros(16), torch.zeros(16), 0
    if bad == "noncontig":
        a = torch.zeros(32)[::2]
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.to(torch.bfloat16)
    elif bad == "shape":
        b = torch.zeros(15)
    elif bad == "2d":
        a, b = a.view(4, 4), b.view(4, 4)
    elif bad == "op":
        op = 4
    with pytest.raises((TypeError, ValueError)):
        chunk_combine(a, b, op)
