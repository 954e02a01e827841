"""Plain PyTorch references of what the benchmark's cells compute.

They import nothing of the program and take nothing it made: the harness
hands them the weights and inputs it drew from the seed, and they work out
the losses, gradients, optimizer steps and layer outputs again.  Matrix
products run in float32 with TF32 off unless a caller asks for a lower
precision (the control, ``numerics.py``).
"""
