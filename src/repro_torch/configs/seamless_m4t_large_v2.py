"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].  The modality frontend is a STUB per spec:
``input_specs()`` provides precomputed frame embeddings [B, frames, D].
Both encoder and decoder have 24 layers; decode shapes run against the
decoder with cross-attention to stub encoder memory."""
from .base import ArchConfig, _FULL_ATTN_500K_SKIP

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, enc_frames=1024,
    skip_cells=(_FULL_ATTN_500K_SKIP,),
)
