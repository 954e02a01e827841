"""h2o-danube-3-4b [dense] — llama+mistral mix, sliding-window attention
[arXiv:2401.16818].  SWA makes long_500k sub-quadratic, so it runs."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
    d_ff=10240, vocab=32000, swa_window=4096,
)
