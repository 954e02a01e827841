"""The mesh fabric of the port (``repro_torch.core.daemon``): the packed
16-bit exchange, the fused per-ring-group exchange against the sim's
gather, and the permute counts of ``repro.core.daemon``'s record.

The port's pack is a pure bit view, so it is held to the RAW input bits
over every 16-bit pattern (the reference's pack quiets bfloat16 signalling
NaNs at odd widths, so it is not the yardstick here)."""
import numpy as np
import pytest
import torch

from repro.core import OcclConfig as JConfig
from repro.core.daemon import count_exchange_ppermutes as j_count
from repro_torch.core import Communicator, OcclConfig
from repro_torch.core.daemon import (
    _mesh_exchange,
    _pack16_to_i32,
    _sim_exchange,
    _unpack16_from_i32,
    count_exchange_ppermutes,
)
from repro_torch.core.scheduler import Mailbox
from repro_torch.core.tables import build_tables
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
ALL16 = np.arange(1 << 16, dtype=np.uint16)


def _rows(width: int) -> np.ndarray:
    """Every 16-bit pattern, laid out as rows of ``width`` (the last row
    wraps round to the start)."""
    n = -(-ALL16.size // width) * width
    return np.resize(ALL16, n).reshape(-1, width)


def _as16(bits: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(DTYPES[dtype])


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("width", [1, 2, 7, 8, 31, 64])
def test_pack16_is_a_bit_view_of_every_pattern(dtype, width):
    """Every 16-bit pattern (signalling NaNs included) packs into i32 lanes
    as its raw bits, low half first, pad lane zero, and unpacks to itself."""
    bits = _rows(width)
    pad = width % 2
    packed = _pack16_to_i32(_as16(bits, dtype), pad)
    assert packed.dtype == torch.int32
    assert tuple(packed.shape) == (bits.shape[0], (width + pad) // 2)
    want = np.concatenate(
        [bits, np.zeros((bits.shape[0], pad), np.uint16)], 1)
    assert packed.numpy().view(np.uint16).tobytes() == want.tobytes()
    out = _unpack16_from_i32(packed, DTYPES[dtype], width)
    assert out.dtype == DTYPES[dtype]
    assert _raw(out).tobytes() == bits.tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack16_commutes_with_ring_permutation(dtype, seed):
    """A permute moves whole rows: packing, permuting the i32 rows and
    unpacking equals permuting the raw 16-bit rows."""
    rng = np.random.RandomState(seed)
    ring, width = 8, 33                                    # odd -> pad lane
    bits = rng.randint(0, 1 << 16, size=(ring, width)).astype(np.uint16)
    perm = np.roll(np.arange(ring), 3 + seed)
    packed = _pack16_to_i32(_as16(bits, dtype), width % 2)
    got = _unpack16_from_i32(packed[torch.from_numpy(perm)], DTYPES[dtype],
                             width)
    assert _raw(got).tobytes() == bits[perm].tobytes()


def _tables(dtype: str, packed: bool, lanes_per_group: int):
    """R=8 tables: ``lanes_per_group`` lanes on the world ring (one fused
    group) plus a lane on the even ranks' ring (a group of its own) and an
    unregistered lane."""
    R = 8
    cfg = OcclConfig(n_ranks=R, max_comms=lanes_per_group + 2,
                     slice_elems=5, burst_slices=3, dtype=dtype,
                     packed_16bit=packed)
    comms = [Communicator(comm_id=i, members=tuple(range(R)), lane=i)
             for i in range(lanes_per_group)]
    comms.append(Communicator(comm_id=lanes_per_group,
                              members=(0, 2, 4, 6), lane=lanes_per_group))
    return cfg, build_tables(cfg, comms, [])


def _outbox(cfg, seed: int) -> Mailbox:
    """Seeded [R, L, ...] outbox; the payload is random BITS (NaNs of every
    kind included)."""
    rng = np.random.RandomState(seed)
    R, L, B, SL = (cfg.n_ranks, cfg.max_comms, cfg.burst_slices,
                   cfg.slice_elems)
    ints = lambda: torch.from_numpy(
        rng.randint(-5, 1 << 20, (R, L)).astype(np.int32))
    dt = DTYPES[cfg.dtype]
    if dt.itemsize == 2:
        raw = rng.randint(0, 1 << 16, (R, L, B, SL)).astype(np.uint16)
    else:
        raw = rng.randint(0, 1 << 32, (R, L, B, SL), dtype=np.uint64
                          ).astype(np.uint32)
    pay = torch.from_numpy(raw.view(raw.dtype.str.replace("u", "i"))
                           .copy()).view(dt)
    return Mailbox(fwd_count=ints(), fwd_coll=ints(), fwd_payload=pay,
                   rev_count=ints(), rev_coll=ints())


def _field_bits(t: torch.Tensor) -> np.ndarray:
    if t.is_floating_point():
        t = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    return t.numpy()


@pytest.mark.parametrize("lanes_per_group", [1, 2])
@pytest.mark.parametrize("dtype,packed", [
    ("float32", True), ("bfloat16", True), ("bfloat16", False),
    ("float16", True), ("float16", False)])
def test_mesh_exchange_equals_sim_exchange(dtype, packed, lanes_per_group):
    """Every rank's inbox from the fused exchange equals the sim's gather
    bit for bit on every registered lane; an unregistered lane receives
    zeros (the reference's ppermute semantics)."""
    cfg, t = _tables(dtype, packed, lanes_per_group)
    assert len(t.lane_groups) == 2
    assert [len(g[0]) for g in t.lane_groups] == [lanes_per_group, 1]
    for seed in range(3):
        ob = _outbox(cfg, seed)
        want = _sim_exchange(torch.as_tensor(t.fwd_src, dtype=torch.int64),
                             torch.as_tensor(t.rev_src, dtype=torch.int64),
                             ob)
        got = _mesh_exchange(t, [Mailbox(*(f[r:r + 1] for f in ob))
                                 for r in range(cfg.n_ranks)])
        live = lanes_per_group + 1                  # lanes of some group
        for f in Mailbox._fields:
            g = torch.cat([getattr(mb, f) for mb in got])
            w = getattr(want, f)
            np.testing.assert_array_equal(_field_bits(g[:, :live]),
                                          _field_bits(w[:, :live]),
                                          err_msg=f)
            assert not _field_bits(g[:, live:]).any(), f


# The permute counts of tests/test_daemon_fastpath.py (config, n_comms,
# count) and of BENCH_collectives.json "mesh" "ppermutes_per_superstep".
COUNTS = [
    (dict(slice_elems=8, burst_slices=4, dtype="bfloat16"), 1, 2),
    (dict(slice_elems=8, burst_slices=4, dtype="float16"), 1, 2),
    (dict(slice_elems=8, burst_slices=4, dtype="bfloat16",
          packed_16bit=False), 1, 3),
    (dict(slice_elems=8, burst_slices=4, dtype="float16",
          packed_16bit=False), 1, 3),
    (dict(slice_elems=8, burst_slices=4), 1, 2),
    (dict(slice_elems=7, burst_slices=1, dtype="bfloat16"), 1, 2),
    (dict(max_comms=2, slice_elems=8, burst_slices=2, dtype="bfloat16"), 2,
     2),
    (dict(slice_elems=64, burst_slices=4), 1, 2),
    (dict(slice_elems=64, burst_slices=4, dtype="bfloat16"), 1, 2),
    (dict(slice_elems=64, burst_slices=4, dtype="bfloat16",
          packed_16bit=False), 1, 3),
    (dict(slice_elems=64, burst_slices=4, dtype="float16"), 1, 2),
]


@pytest.mark.parametrize("kw,n_comms,want", COUNTS)
def test_exchange_permute_counts(kw, n_comms, want):
    """The exchange's permutes per superstep equal the record's and the
    reference's ppermute count for the same config."""
    kw = dict(dict(n_ranks=8, max_comms=1), **kw)
    got = count_exchange_ppermutes(OcclConfig(**kw), n_comms=n_comms)
    assert got == want == j_count(JConfig(**kw), n_comms=n_comms)
