"""Precision switches of the reference: float32 products with TF32 off,
and the operand roundings of the controls, one precision below the
configuration's: TF32 operands (10 stored mantissa bits) for a float32
configuration, float8 e4m3 operands under one per-tensor scale for a
bfloat16 one.  The roundings are done on the operands and the products
then accumulate in float32, as the tensor cores do, so a control reads the
same on the CPU and on the card."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0      # largest finite float8_e4m3fn


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Run the block's float32 products in TF32 (``tf32``) or in full
    float32; restores the process's settings after."""
    cuda = torch.backends.cuda.matmul
    old = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
    cuda.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), back in ``x``'s dtype; the gradient passes
    straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x
