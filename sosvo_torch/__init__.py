"""sosvo_torch: the omnistereo visual-odometry pipeline in PyTorch and CUDA.

A port of the JAX package `sosvo` (the reference, left unchanged beside it)
to PyTorch on an NVIDIA Hopper GPU. Module paths mirror `sosvo/` so each
counterpart is easy to find. Plain tensor code is PyTorch; the Hamming
matcher, which `sosvo` wrote as a Pallas TPU kernel, is a hand-written CUDA
kernel (`sosvo_torch/csrc/match_hamming.cu`, bound in
`sosvo_torch/kernels/match_cuda.py`). On CPU tensors every kernel wrapper
runs its plain PyTorch twin, which is how the CPU tests reach it.

This package never imports jax or `sosvo`.
"""

import torch as _torch

# Geometry correctness requires true-f32 matmuls (mirror of
# `sosvo/__init__.py`, which pins jax_default_matmul_precision="highest"):
# TF32 keeps ~3 decimal digits, which breaks the pose math (3x3 chains,
# normal equations, Procrustes). The Hamming matcher's +/-1 matmul is exact
# in f32 and needs no lower precision either.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
