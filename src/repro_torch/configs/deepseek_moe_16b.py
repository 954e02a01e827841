"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
experts (d_ff 1408) [arXiv:2401.06066].

Deviation from the HF checkpoint: the real model's layer 0 is dense; the
assigned spec sheet gives a uniform MoE stack, which we follow.
"""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
