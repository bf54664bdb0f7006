"""Kernel G: the non-overlapping k x k window mean of a channels-last field,
in XLA's order of additions. CUDA kernel (``csrc/resample.cu``) and plain
version.

No TPU kernel: the JAX package's ``probunet_tpu/ops/resample.py:avg_pool``
is a reshape-mean that XLA lowers to one reduction. XLA on the CPU adds
each window's k*k terms one by one in row-major order (row i, then column
j), starting from zero, and multiplies the sum by f32(1 / k^2); it does not
divide. ``Tensor.mean`` over the window axes adds in another order, so its
last bit differs from JAX's on most outputs of a field that spans six decades, and
the per-pixel statistics of the ingest inherit it. Both versions here add
in XLA's order, so the pooled field is the JAX package's bit for bit.

- :func:`window_mean_plain`: k*k additions of strided views of x, then the
  product; used for CPU tensors (the tests, host ingest on the CPU).
- :func:`window_mean`: the wrapper. A CUDA tensor launches kernel G (f32,
  row-major (..., H, W, C)), one launch a pooling, or raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/resample.cu"
REPLACES = "probunet_tpu/ops/resample.py:31"   # x.mean(axis=(-4, -2))


def inverse_area(k: int) -> np.float32:
    """f32(1 / k^2), the factor XLA multiplies each window's sum by."""
    return np.float32(1.0 / (k * k))


def _check_shape(x: torch.Tensor, k: int) -> None:
    if x.dim() < 3:
        raise ValueError(f"window_mean: x must be (..., H, W, C), got shape {tuple(x.shape)}")
    h, w = x.shape[-3:-1]
    if k < 1 or h % k or w % k:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {k}")


def window_mean_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k window means of x (..., H, W, C): each window's terms
    added in row-major order from zero (in f32, or f64 for f64 x), the sum
    times f32(1 / k^2), cast to x's type."""
    _check_shape(x, k)
    *lead, h, w, c = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    v = x.reshape(*lead, h // k, k, w // k, k, c)
    acc = torch.zeros((*lead, h // k, w // k, c), dtype=acc_dtype, device=x.device)
    for i in range(k):
        for j in range(k):
            acc += v[..., i, :, j, :]
    acc *= torch.tensor(float(inverse_area(k)), dtype=acc_dtype, device=x.device)
    return acc.to(x.dtype)


def _launch(x: torch.Tensor, k: int) -> torch.Tensor:
    _check_shape(x, k)
    if x.dtype != torch.float32:
        raise ValueError(f"window_mean: kernel G takes f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"window_mean: x (shape {tuple(x.shape)}, strides {x.stride()}) "
                         "is not row-major contiguous")
    *lead, h, w, c = x.shape
    out = torch.empty((*lead, h // k, w // k, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _build.library().window_mean_f32(
            x.data_ptr(), out.data_ptr(), math.prod(lead), h, w, c, k, float(inverse_area(k)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "window_mean_f32")
    window_mean.launches += 1
    return out


def window_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k window means of x (..., H, W, C) in XLA's order of
    additions: :func:`window_mean_plain` for a CPU tensor, kernel G for a
    CUDA tensor (f32, contiguous; anything else raises)."""
    if x.device.type == "cpu":
        return window_mean_plain(x, k)
    return _launch(x, k)


window_mean.launches = 0
