"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-0.6B].

Note: Qwen3 decouples head_dim (128) from d_model/n_heads.
"""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
