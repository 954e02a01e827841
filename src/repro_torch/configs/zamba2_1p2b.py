"""zamba2-1.2b [hybrid] — Mamba2 trunk + ONE weight-shared attention block
applied every 6 SSM layers [arXiv:2411.15242].  The shared block consumes
concat(hidden, embedding residual) through a 2D->D projector, as in Zamba.
long_500k runs (SSM trunk is linear; the shared attention decodes against
its KV cache, linear per token)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_groups=2,
    shared_attn_period=6,
)
