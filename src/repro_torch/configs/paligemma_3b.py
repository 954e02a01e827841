"""paligemma-3b [vlm] — SigLIP frontend (STUB: precomputed patch
embeddings) + gemma backbone, MQA (kv=1), prefix-LM attention over the
image+prefix tokens [arXiv:2407.07726]."""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab=257216,
    vis_tokens=256,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
