"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
