"""The superstep's slice burst: ``fused_burst_plain`` (the port's CPU path
of ``kernels.fused_slice.fused_burst``) against a JAX composition of the
reference scheduler's own block, bit for bit.

The reference block (``src/repro/core/scheduler.py``) gathers the
connector slot rows and the ``heap_in`` windows (:564-583), applies
``fused_primitive_pallas`` (here in interpret mode) and blends each lane's
window into ``heap_out`` in lane order (:606-620); the outbox is the value
cast to the payload dtype (:789).  :func:`_reference_burst` writes that
block out per rank with the reference's own operations.  The inputs are a
seeded numpy sweep over ranks, lanes, burst widths, slice widths, dtypes
and ops, with slot indices that wrap past K, partial bursts, lanes that do
not write, ranks that are not live, overlapping output windows (the later
lane wins), windows clamped at both ends of the heap, invalid lanes and
NaN / +-inf entries.  The CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it bitwise against the same plain version.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_slice import fused_primitive_pallas
from repro_torch.core import primitives as TP
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fused_slice import (BurstLanes, BurstTables,
                                             fused_burst, fused_burst_plain)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PRIM_TABLES = (TP.PRIM_RECV, TP.PRIM_REDUCE, TP.PRIM_READS_IN)


def _case(seed, R, L, B, SL, dtype):
    """Seeded numpy inputs of one burst: (payload, heap_in, heap_out,
    lanes dict, tables dict), floats as float32 (rounded to ``dtype``
    later)."""
    rng = np.random.RandomState(seed)
    C = L + 2
    K = int(rng.choice([B, 2 * B + 1]))
    W = B * SL
    H = 5 * W + 13                      # odd: windows start unaligned
    i32 = lambda a: np.asarray(a, np.int32)

    def floats(*shape):
        x = rng.randn(*shape).astype(np.float32)
        flat = x.reshape(-1)
        for v, step in ((np.nan, 29), (np.inf, 31), (-np.inf, 37)):
            flat[rng.randint(step)::step] = v
        return x

    coll = rng.randint(0, C, (R, L))
    for l in range(1, L):               # some lanes share a window
        same = rng.rand(R) < 0.3
        coll[same, l] = coll[same, l - 1]
    n = rng.randint(0, B + 1, (R, L))
    write = rng.rand(R, L) < 0.7
    write[0] = False                    # rank 0 is not live
    invalid = rng.rand(R, L) < 0.15     # cand < 0: c clamps to 0, no gate
    coll[invalid], n[invalid], write[invalid] = 0, 0, False
    lanes = dict(coll=i32(coll), tail=i32(rng.randint(0, 3 * K, (R, L))),
                 rnd=i32(rng.randint(0, 3, (R, L))),
                 sl=i32(rng.randint(0, 4, (R, L))),
                 chunk=i32(rng.randint(0, 3, (R, L))),
                 prim=i32(rng.randint(0, len(TP.PRIM_RECV), (R, L))),
                 n=i32(n), write=write)
    # Offsets below 0 and past H - W clamp; the rest land anywhere.
    tables = dict(in_off=i32(rng.randint(-2 * W, H + W, (R, C))),
                  out_off=i32(rng.randint(-2 * W, H + W, (R, C))),
                  n_rounds=i32(rng.randint(1, 3, C)),
                  n_slices=i32(rng.randint(1, 4, C)),
                  in_chunked=i32(rng.randint(0, 2, C)),
                  out_chunked=i32(rng.randint(0, 2, C)),
                  op=i32(rng.randint(0, 4, C)))
    return (floats(R, C, K, SL), floats(R, H), floats(R, H), lanes, tables)


def _reference_burst(payload, heap_in, heap_out, B, lanes, tables):
    """The reference scheduler's burst block, vmapped over ranks as the
    reference runs it."""
    SL, K = payload.shape[3], payload.shape[2]
    L = lanes["coll"].shape[1]
    bidx = jnp.arange(B, dtype=jnp.int32)
    span = jnp.arange(B * SL, dtype=jnp.int32)
    shared = {f: jnp.asarray(v) for f, v in tables.items()
              if f not in ("in_off", "out_off")}
    recv_t, reduce_t, reads_t = (jnp.asarray(t) for t in PRIM_TABLES)

    def rank(payload, heap_in, heap_out, ln, in_off, out_off):
        c = ln["coll"]
        nsl = shared["n_slices"][c]
        slots = (ln["tail"][:, None] + bidx[None, :]) % K       # [L, B]
        recv_val = payload[c[:, None], slots]                   # [L, B, SL]
        chunk_stride = shared["n_rounds"][c] * nsl * SL
        within = (ln["rnd"] * nsl + ln["sl"]) * SL
        in_base = (in_off[c]
                   + jnp.where(shared["in_chunked"][c] > 0, ln["chunk"], 0)
                   * chunk_stride + within)
        out_base = (out_off[c]
                    + jnp.where(shared["out_chunked"][c] > 0, ln["chunk"], 0)
                    * chunk_stride + within)
        in_val = jnp.stack([
            jax.lax.dynamic_slice(heap_in, (in_base[l],), (B * SL,))
            for l in range(L)]).reshape(L, B, SL)
        prim = ln["prim"]
        flags = jnp.stack([(recv_t[prim] > 0).astype(jnp.int32),
                           (reduce_t[prim] > 0).astype(jnp.int32),
                           (reads_t[prim] > 0).astype(jnp.int32),
                           shared["op"][c].astype(jnp.int32)], axis=1)
        flags_lb = jnp.broadcast_to(flags[:, None, :],
                                    (L, B, 4)).reshape(L * B, 4)
        value = fused_primitive_pallas(
            recv_val.reshape(L * B, SL), in_val.reshape(L * B, SL),
            flags_lb, interpret=True).reshape(L, B, SL)
        out_limit = jnp.where(ln["write"], ln["n"], 0) * SL
        vals = value.reshape(L, B * SL).astype(heap_out.dtype)
        for l in range(L):
            window = jax.lax.dynamic_slice(heap_out, (out_base[l],),
                                           (B * SL,))
            blend = jnp.where(span < out_limit[l], vals[l], window)
            heap_out = jax.lax.dynamic_update_slice(heap_out, blend,
                                                    (out_base[l],))
        return heap_out, value.astype(payload.dtype)

    ln = {f: jnp.asarray(v) for f, v in lanes.items()}
    return jax.jit(jax.vmap(rank))(payload, heap_in, heap_out, ln,
                                   jnp.asarray(tables["in_off"]),
                                   jnp.asarray(tables["out_off"]))


def _to_torch(a: np.ndarray, td) -> torch.Tensor:
    a = np.asarray(a)
    if td == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _torch_args(lanes, tables):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (BurstLanes(**{f: t(v) for f, v in lanes.items()}),
            BurstTables(**{f: t(v) for f, v in tables.items()},
                        prim_recv=t(TP.PRIM_RECV),
                        prim_reduce=t(TP.PRIM_REDUCE),
                        prim_reads_in=t(TP.PRIM_READS_IN)))


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_bitwise(got, want):
    """Bitwise equal, NaN compared as "both NaN" (payload bits may differ)."""
    gn = torch.isnan(got.float()).numpy()
    wn = np.isnan(np.asarray(want, np.float32))
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_array_equal(_bits(got)[~gn], _bits(want)[~wn])


def _seed(dtype, SL, B, L, R) -> int:
    return (((list(DTYPES).index(dtype) * 100 + SL) * 10 + B) * 10 + L) \
        * 10 + R


def _run_both(R, L, B, SL, dtype, seed):
    payload, heap_in, heap_out, lanes, tables = _case(seed, R, L, B, SL,
                                                      dtype)
    jd, td = DTYPES[dtype]
    jp, ji, jo = (jnp.asarray(a, jd) for a in (payload, heap_in, heap_out))
    want_heap, want_out = _reference_burst(jp, ji, jo, B, lanes, tables)
    tp, ti, to = (_to_torch(np.asarray(a), td) for a in (jp, ji, jo))
    got_out = fused_burst_plain(tp, ti, to, B, *_torch_args(lanes, tables))
    assert got_out.shape == (R, L, B, SL) and got_out.dtype == td
    _assert_bitwise(got_out, want_out)
    _assert_bitwise(to, want_heap)


# dtype x slice x burst, each with every lane count and both rank counts.
SWEEP = list(itertools.product(DTYPES, (4, 64), (1, 4, 8)))
LANES_RANKS = ((1, 2), (2, 4), (3, 2))


@pytest.mark.parametrize("dtype,SL,B", SWEEP)
def test_plain_burst_matches_reference_block_sweep(dtype, SL, B):
    for L, R in LANES_RANKS:
        _run_both(R, L, B, SL, dtype, seed=_seed(dtype, SL, B, L, R))


def test_sweep_hits_every_hazard():
    """The seeded cases reach what they are meant to: slot indices that
    wrap past K, partial bursts, lanes of one rank that write the same
    window, windows clamped at both ends, ranks that are not live, invalid
    lanes, every op and every primitive."""
    hits = dict(wrap=0, partial=0, overlap=0, clamp_lo=0, clamp_hi=0,
                invalid=0, op=set(), prim=set())
    for (dtype, SL, B), (L, R) in itertools.product(SWEEP, LANES_RANKS):
        payload, _, _, lanes, t = _case(_seed(dtype, SL, B, L, R), R, L, B,
                                        SL, dtype)
        K, W = payload.shape[2], B * SL
        H = 5 * W + 13
        c, n, w = lanes["coll"], lanes["n"], lanes["write"]
        assert not w[0].any()                   # rank 0 not live
        hits["wrap"] += int((lanes["tail"] + B - 1 >= K).sum())
        hits["partial"] += int(((n > 0) & (n < B)).sum())
        off = np.take_along_axis(t["out_off"], c, 1)
        hits["clamp_lo"] += int((off < 0).sum())
        hits["clamp_hi"] += int((off > H - W).sum())
        hits["invalid"] += int(((c == 0) & (n == 0) & ~w).sum())
        for r in range(R):
            for a, b in itertools.combinations(range(L), 2):
                hits["overlap"] += int(w[r, a] and w[r, b] and n[r, a] > 0
                                       and n[r, b] > 0 and c[r, a] == c[r, b])
        hits["op"] |= set(t["op"].tolist())
        hits["prim"] |= set(lanes["prim"].ravel().tolist())
    for k in ("wrap", "partial", "overlap", "clamp_lo", "clamp_hi",
              "invalid"):
        assert hits[k] > 0, hits
    assert hits["op"] == {0, 1, 2, 3}, hits
    assert hits["prim"] == set(range(len(TP.PRIM_RECV))), hits


def test_later_lane_wins_on_overlap():
    """Two lanes of one rank write the same output window from different
    input windows: heap_out holds the second lane's rows."""
    R, L, B, SL = 2, 2, 4, 8
    W = B * SL
    payload, _, heap_out, lanes, tables = _case(5, R, L, B, SL, "float32")
    heap_in = np.arange(R * (5 * W + 13), dtype=np.float32).reshape(R, -1)
    lanes.update(coll=np.ones((R, L), np.int32),
                 chunk=np.array([[0, 1]] * R, np.int32),
                 rnd=np.zeros((R, L), np.int32),
                 sl=np.zeros((R, L), np.int32),
                 n=np.full((R, L), B, np.int32), write=np.ones((R, L), bool),
                 prim=np.full((R, L), int(TP.Prim.COPY), np.int32))
    tables["in_off"][:, 1] = 0
    tables["out_off"][:, 1] = 2 * W
    tables["n_rounds"][1], tables["n_slices"][1] = 1, B
    tables["in_chunked"][1], tables["out_chunked"][1] = 1, 0
    to = torch.from_numpy(heap_out.copy())
    fused_burst_plain(torch.from_numpy(payload), torch.from_numpy(heap_in),
                      to, B, *_torch_args(lanes, tables))
    # lane 1 reads its input one chunk (n_rounds * n_slices * SL = W) in
    np.testing.assert_array_equal(to[:, 2 * W:3 * W].numpy(),
                                  heap_in[:, W:2 * W])
    want, _ = _reference_burst(jnp.asarray(payload), jnp.asarray(heap_in),
                               jnp.asarray(heap_out), B, lanes, tables)
    _assert_bitwise(to, want)


def test_dispatch_routes_cpu_tensors_to_plain_version():
    payload, heap_in, heap_out, lanes, tables = _case(7, 2, 2, 4, 8,
                                                      "float32")
    args = _torch_args(lanes, tables)
    before = fused_burst.launches
    h1, h2 = torch.from_numpy(heap_out.copy()), torch.from_numpy(
        heap_out.copy())
    got = tops.fused_burst(torch.from_numpy(payload),
                           torch.from_numpy(heap_in), h1, 4, *args)
    want = tops.fused_burst_plain(torch.from_numpy(payload),
                                  torch.from_numpy(heap_in), h2, 4, *args)
    assert torch.equal(_bits_t(got), _bits_t(want))
    assert torch.equal(_bits_t(h1), _bits_t(h2))
    assert fused_burst.launches == before      # no kernel on the CPU


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _good_args():
    payload, heap_in, heap_out, lanes, tables = _case(9, 2, 2, 2, 8,
                                                      "float32")
    lanes_t, tables_t = _torch_args(lanes, tables)
    return dict(payload=torch.from_numpy(payload),
                heap_in=torch.from_numpy(heap_in),
                heap_out=torch.from_numpy(heap_out), burst=2,
                lanes=lanes_t, tables=tables_t)


@pytest.mark.parametrize("bad", [
    "float64", "mixed_heap", "mixed_payload", "lanes_int64", "write_int32",
    "tables_int64", "lanes_shape", "tables_shape", "payload_3d",
    "heap_rows", "burst_too_wide", "noncontig_heap", "noncontig_payload",
    "noncontig_lane", "alias", "device_mixed", "device_meta"])
def test_wrapper_refuses_bad_inputs(bad):
    a = _good_args()
    lanes, tables = a["lanes"], a["tables"]
    if bad == "float64":
        a.update(payload=a["payload"].double(), heap_in=a["heap_in"].double(),
                 heap_out=a["heap_out"].double())
    elif bad == "mixed_heap":
        a["heap_out"] = a["heap_out"].to(torch.bfloat16)
    elif bad == "mixed_payload":
        a["payload"] = a["payload"].to(torch.bfloat16)
    elif bad == "lanes_int64":
        a["lanes"] = lanes._replace(tail=lanes.tail.long())
    elif bad == "write_int32":
        a["lanes"] = lanes._replace(write=lanes.write.int())
    elif bad == "tables_int64":
        a["tables"] = tables._replace(op=tables.op.long())
    elif bad == "lanes_shape":
        a["lanes"] = lanes._replace(n=lanes.n[:, :1].contiguous())
    elif bad == "tables_shape":
        a["tables"] = tables._replace(in_off=tables.in_off[:, :2].contiguous())
    elif bad == "payload_3d":
        a["payload"] = a["payload"][:, 0]
    elif bad == "heap_rows":
        a["heap_in"] = a["heap_in"][:1].contiguous()
    elif bad == "burst_too_wide":
        a["burst"] = a["heap_in"].shape[1]
    elif bad == "noncontig_heap":
        a["heap_out"] = torch.zeros(a["heap_out"].shape[::-1]).t()
    elif bad == "noncontig_payload":
        a["payload"] = a["payload"].transpose(2, 3)
    elif bad == "noncontig_lane":
        a["lanes"] = lanes._replace(rnd=lanes.rnd.t().contiguous().t())
    elif bad == "alias":
        a["heap_out"] = a["heap_in"]
    elif bad == "device_mixed":
        a["tables"] = tables._replace(op=tables.op.to("meta"))
    elif bad == "device_meta":
        a = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
             for k, v in a.items()}
        a["lanes"] = BurstLanes(*(t.to("meta") for t in lanes))
        a["tables"] = BurstTables(*(t.to("meta") for t in tables))
    with pytest.raises((TypeError, ValueError)):
        fused_burst(a["payload"], a["heap_in"], a["heap_out"], a["burst"],
                    a["lanes"], a["tables"])


def test_padded_payload_rank_stride_is_accepted():
    """The inbox commit leaves the connector as a view with a padded rank
    stride; the burst reads it as it is."""
    a = _good_args()
    p = a["payload"]
    R, C, K, SL = p.shape
    padded = torch.cat([p.reshape(R, C * K, SL),
                        torch.zeros(R, 1, SL)], 1)[:, :C * K].reshape(p.shape)
    assert not padded.is_contiguous()
    h1, h2 = a["heap_out"].clone(), a["heap_out"].clone()
    got = fused_burst(padded, a["heap_in"], h1, 2, a["lanes"], a["tables"])
    want = fused_burst(p, a["heap_in"], h2, 2, a["lanes"], a["tables"])
    assert torch.equal(_bits_t(got), _bits_t(want))
    assert torch.equal(_bits_t(h1), _bits_t(h2))
