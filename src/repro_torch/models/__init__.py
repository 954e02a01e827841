"""Model zoo of the port: the dense, moe, ssm, hybrid, encdec and vlm
families and ViT (the paper's model)."""
from .io import (TensorSpec, decode_specs, input_specs, make_concrete,
                 train_specs)
from .transformer import Model, build_model

__all__ = ["Model", "build_model", "TensorSpec", "decode_specs",
           "input_specs", "make_concrete", "train_specs"]
