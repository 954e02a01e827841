"""Model zoo of the port: the dense and moe families and ViT (the paper's
model)."""
from .io import TensorSpec, train_specs
from .transformer import Model, build_model

__all__ = ["Model", "build_model", "TensorSpec", "train_specs"]
