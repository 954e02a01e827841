"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

# Dense matrix-product rates by the precision the products run in.
MATMUL_FLOPS_PER_S = {
    "fp8": 1979e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "tf32": 495e12,
    "fp32": 67e12,
}
