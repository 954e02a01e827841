"""stablelm-3b [dense] — MHA (kv = n_heads) [hf:stabilityai/stablelm-*]."""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=6912, vocab=50304,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
