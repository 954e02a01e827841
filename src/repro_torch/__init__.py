"""repro_torch: the PyTorch / CUDA port of the ``repro`` OCCL package.

Same subpackage layout as ``repro`` (``core/``, ``kernels/``), written in
PyTorch's idiom: plain functions on tensors, state as NamedTuples of
tensors with the leading [R] rank axis, an explicit device.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
