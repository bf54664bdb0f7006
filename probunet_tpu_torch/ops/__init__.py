"""Tensor ops: resampling, diagonal-Gaussian math, CRPS losses, and the
hand-written CUDA kernels (``ops.kernels``) with their plain versions."""
