"""Architecture + shape-cell configuration system.

The port's own copy of ``repro.configs.base`` (plain dataclasses; the port
imports nothing of the JAX package).  Each architecture is a frozen
``ArchConfig`` in its own module (``repro_torch/configs/<id>.py``),
selectable via ``--arch <id>`` in the launchers.  ``reduced()`` returns a
tiny same-family config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | vit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # --- attention flavor ------------------------------------------------
    qk_norm: bool = False
    swa_window: int = 0          # 0 = full attention; >0 = sliding window
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0

    # --- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_dconv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (zamba2): one shared attn block every N ssm layers ---------
    shared_attn_period: int = 0

    # --- enc-dec (seamless) -------------------------------------------------
    enc_layers: int = 0
    enc_frames: int = 1024       # stub audio frontend: frames per sample

    # --- vlm (paligemma) -----------------------------------------------------
    vis_tokens: int = 0          # stub patch frontend: tokens per image

    # --- numerics / training -------------------------------------------------
    param_dtype: str = "float32"     # master params
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"    # AdamW moments (bf16 for kimi-scale)
    remat: str = "full"              # full | dots | none
    zero1: bool = True               # shard optimizer state over data axis

    # --- shape-cell applicability --------------------------------------------
    skip_cells: tuple = ()       # (cell_name, reason) pairs

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def cells(self) -> list[str]:
        skip = {c for c, _ in self.skip_cells}
        return [c for c in SHAPES if c not in skip]

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 5),
            d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab=256,
        )
        if self.n_experts:
            r.update(n_experts=8, top_k=min(self.top_k, 2),
                     n_shared_experts=min(self.n_shared_experts, 1),
                     d_ff_expert=32)
        if self.ssm_state:
            r.update(ssm_state=16, ssm_headdim=16, ssm_groups=1,
                     ssm_chunk=8)
        if self.shared_attn_period:
            r.update(shared_attn_period=2)
        if self.enc_layers:
            r.update(enc_layers=2, enc_frames=24)
        if self.vis_tokens:
            r.update(vis_tokens=8)
        if self.swa_window:
            r.update(swa_window=8)
        return dataclasses.replace(self, **r)


_FULL_ATTN_500K_SKIP = (
    "long_500k",
    "pure full attention is quadratic at 512k tokens; skipped per spec "
    "(run only for SSM / hybrid / sliding-window archs)",
)
