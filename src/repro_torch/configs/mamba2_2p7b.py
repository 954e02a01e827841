"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].  d_ff=0: no MLP blocks; 64L of Mamba2 mixers.
long_500k runs (linear-time decode with O(1) state)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=8,
)
