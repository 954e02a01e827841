"""The FLOP counts against values worked by hand, and the peaks."""
import json

import pytest

import occl_bench_tiny as tiny
from occl_bench.roofline import flops, peaks


def config(name):
    return json.loads((tiny.BENCH / "configs" / f"{name}.json").read_text())


def test_one_vit_base_layer_forward_and_backward_at_batch_128():
    # per image: q, k, v 2*196*768*2304 = 693633024, output 2*196*768*768
    # = 231211008, scores and values 2 * 2*196*196*768 = 118013952, MLP
    # 2 * 2*196*768*3072 = 1849688064; sum 2892546048; x 3 x 128
    vit = tiny.family_of("vit-base-dp4")
    assert 3 * 128 * vit.layer_forward(196, 768, 3072) == 1110737682432


def test_vit_base_dp4_step():
    # layer 2892546048 + patches 2*196*768*768 = 231211008 + head
    # 2*768*1000 = 1536000 -> 3125293056 per image, x 3 x 128
    assert flops.step_flops(config("vit-base-dp4")) == 1200112533504


def test_deepseek_moe_layer_forward_over_four_ranks():
    # 4096 tokens: router 2*4096*2048*64 = 1073741824; six experts of
    # three 2048 x 1408 products 4096*6*6*2048*1408 = 425201762304; two
    # shared experts 4096*6*2048*2816 = 141733920768
    assert flops.step_flops(config("deepseek-moe-16b-ep4")) == 568009424896


def test_peaks_are_the_data_sheet():
    assert peaks.MATMUL_FLOPS_PER_S["bf16"] == 989e12
    assert peaks.MATMUL_FLOPS_PER_S["fp32"] == 67e12


@pytest.mark.parametrize("name", tiny.CONFIGS)
def test_step_flops_are_the_named_familys(name):
    cfg = config(name)
    n = flops.step_flops(cfg)
    assert isinstance(n, int) and n > 0
    assert n == tiny.family_of(name).step_flops(cfg)
    assert cfg["precision"]["peak"] in peaks.MATMUL_FLOPS_PER_S
