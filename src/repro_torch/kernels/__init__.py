"""Hand-written Hopper kernels of the port, with their plain PyTorch
versions (``ref.py``) and the dispatch layer (``ops.py``)."""
