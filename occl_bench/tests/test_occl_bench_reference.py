"""The plain references against the port's own entries, on the same
inputs at a small size on the CPU (a test may import both; the references
import nothing of the port)."""
import dataclasses

import pytest
import torch

import occl_bench_tiny as tiny
from occl_bench.harness import manifest
from occl_bench.harness.port import flatten, nest, port_config
from occl_bench.reference import adamw as ref_adamw
from occl_bench.reference import moe as ref_moe
from occl_bench.reference import numerics
from occl_bench.reference import vit as ref_vit


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vit_setup(seed=3):
    cfg = tiny.config("vit-base-dp4")
    fam = manifest.family(cfg["family"])
    params = fam.params(cfg, seed, "cpu", ref_vit)
    batch = fam.Feed(cfg, seed, "cpu").batch_for(0, 1)
    return cfg, params, batch


def test_vit_loss_and_grads_equal_the_ports():
    from repro_torch.models import build_model

    cfg, params, batch = vit_setup()
    port = build_model(port_config(cfg))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = port.loss_fn(nest(leaves), batch)
    gw = torch.autograd.grad(want, list(leaves.values()))
    got, gg = ref_vit.loss_and_grads(cfg, params, batch["patches"],
                                     batch["labels"])
    want = float(want.detach())
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    for (k, g), w in zip(gg.items(), gw):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-7, msg=k)


def test_vit_published_widths_build_in_the_port():
    full = tiny._load("configs/vit-base-dp4.json")
    assert ref_vit.param_shapes(full)["layers/attn/wq"] == (1, 768, 768)
    manifest.family(full["family"]).check_port_tree(full, port_config(full),
                                                    ref_vit)


def test_adamw_equals_the_ports_over_three_steps():
    from repro_torch.optim.adamw import AdamWConfig, adamw_update

    cfg, params, _ = vit_setup()
    opt = cfg["optimizer"]
    g = torch.Generator().manual_seed(5)
    p_ref = dict(params)
    m_ref = {k: torch.zeros_like(v) for k, v in params.items()}
    v_ref = {k: torch.zeros_like(v) for k, v in params.items()}
    p_port, m_port, v_port = (nest(dict(p_ref)), nest(dict(m_ref)),
                              nest(dict(v_ref)))
    for t in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in
                 params.items()}
        p_ref, m_ref, v_ref = ref_adamw.step(opt, p_ref, grads, m_ref,
                                             v_ref, t)
        p_port, m_port, v_port, _ = adamw_update(
            AdamWConfig(**opt), p_port, nest(grads), m_port,
            v_port, torch.tensor(t, dtype=torch.int32))
    got = flatten(p_port)
    for k in p_ref:
        torch.testing.assert_close(got[k], p_ref[k], rtol=1e-6, atol=1e-9)


def test_learning_rate_schedule_ends():
    opt = tiny.config("vit-base-dp4")["optimizer"]
    assert ref_adamw.learning_rate(opt, 0) == pytest.approx(3e-6)
    assert ref_adamw.learning_rate(opt, 100) == pytest.approx(3e-4)
    assert ref_adamw.learning_rate(opt, 10_000) == pytest.approx(0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_layer_equals_the_ports_expert_parallel_reference(seed):
    from repro_torch.train.occl_moe import ep_forward_ref

    cfg = tiny.config("deepseek-moe-16b-ep4")
    fam = manifest.family(cfg["family"])
    port_cfg = port_config(cfg)
    cap = fam.capacity(cfg, ref_moe)
    params = fam.params(cfg, seed, "cpu", ref_moe)
    xs = fam.tokens(cfg, seed, 0, "cpu")
    want = ep_forward_ref(port_cfg, params, xs, cap=cap)
    got = fam.reference_outputs(cfg, params, xs, cap, ref_moe)
    for g, w in zip(got, want):
        assert float((g - w.double()).abs().max()) <= 1e-6 * float(
            w.abs().max())


def test_capacity_drops_assignments_past_the_slots():
    experts = torch.tensor([0, 1, 0, 0, 1, 0])
    keep = ref_moe.kept(experts, 2, 2)
    assert keep.tolist() == [True, True, True, False, True, False]


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    y = numerics.tf32(x)
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert numerics.tf32(torch.tensor([1.0 + 2.0 ** -12])).item() == 1.0


def test_fp8_rounds_to_e4m3_under_one_scale():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = numerics.fp8(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max()
    assert 1e-3 < float(rel.detach()) <= 2.0 ** -3
    y.sum().backward()
    assert (x.grad == 1).all()


def test_port_widths_are_unchanged_by_the_tiny_configs():
    full = tiny._load("configs/deepseek-moe-16b-ep4.json")
    port = port_config(full)
    assert (port.d_model, port.n_experts, port.top_k, port.n_shared_experts,
            port.d_ff_expert, port.capacity_factor) == (
        full["hidden_size"], full["n_routed_experts"],
        full["num_experts_per_tok"], full["n_shared_experts"],
        full["moe_intermediate_size"], full["capacity_factor"])
    assert dataclasses.is_dataclass(port)


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_weights_follow_the_named_references_shapes_and_the_seed(name):
    cfg = tiny.config(name)
    fam = manifest.family(cfg["family"])
    ref = manifest.reference(cfg["reference"])
    a, b = (fam.params(cfg, 5, "cpu", ref) for _ in range(2))
    c = fam.params(cfg, 6, "cpu", ref)
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(s) for k, s in ref.param_shapes(cfg).items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("cell", tiny.first_cells())
def test_control_reads_a_finite_number_on_each_compared_name(cell):
    from occl_bench.harness import standins

    wl = tiny.workload(cell)
    cfg = tiny.config(wl["config"])
    readings = standins.read(cfg, wl, 3, "cpu", "control")
    assert set(wl["limits"]) <= set(readings)
    assert all(v == v and abs(v) < float("inf") for v in readings.values())
