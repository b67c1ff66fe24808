"""PyTorch/CUDA port of the ``repro`` low-bit serving stack.

Same sub-packages and module names as ``repro``; plain functions on torch
tensors, hand-written CUDA kernels for the TPU kernels of the serving path
(``csrc/``), and their plain PyTorch versions for CPU tensors.
"""
