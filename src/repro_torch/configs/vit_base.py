"""vit-base — the paper's own benchmark model (Sec. 5.3.2): patch 16,
embed dim 768, 16 heads.  Encoder-only classifier used by the training
throughput benchmarks (Fig. 8/10 reproduction); not part of the assigned
10-arch dry-run grid (no decode shapes)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="vit-base", family="vit",
    n_layers=12, d_model=768, n_heads=16, n_kv_heads=16, d_head=48,
    d_ff=3072, vocab=1000,          # vocab = classifier classes
    vis_tokens=196,
    skip_cells=(
        ("prefill_32k", "encoder-only classifier: no serving shapes"),
        ("decode_32k", "encoder-only: no decode step"),
        ("long_500k", "encoder-only: no decode step"),
    ),
)
