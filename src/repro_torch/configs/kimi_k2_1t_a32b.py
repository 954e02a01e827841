"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 routed top-8 + 1 shared
[arXiv:2501.kimi2 per assignment sheet].

Head dim is not on the sheet; we use 128 (MXU-aligned).  Moments are bf16
and ZeRO-1 is forced: 1T params do not fit 512 x 16 GB otherwise (see
EXPERIMENTS.md Dry-run notes).
"""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab=163840,
    n_experts=384, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    param_dtype="bfloat16", moment_dtype="bfloat16", zero1=True,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
