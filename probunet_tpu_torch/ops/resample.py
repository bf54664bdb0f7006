"""Spatial resampling on channels-last fields (port of
``probunet_tpu/ops/resample.py``).

All functions take ``(..., H, W, C)`` tensors and integer factors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean over the (-3, -2) axes (a reshape-mean,
    like ``nn.AvgPool2d(kernel_size=k)``)."""
    if k == 1:
        return x
    *lead, h, w, c = x.shape
    if h % k or w % k:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {k}")
    return x.reshape(*lead, h // k, k, w // k, k, c).mean(dim=(-4, -2))


def upsample_nearest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Nearest-neighbour k-times upsampling over the (-3, -2) axes."""
    if k == 1:
        return x
    return x.repeat_interleave(k, dim=-3).repeat_interleave(k, dim=-2)


def upsample_bilinear(x: torch.Tensor, k: int) -> torch.Tensor:
    """Bilinear k-times upsampling with half-pixel centres
    (``align_corners=False``, the same sampling as ``jax.image.resize``'s
    'linear' when upsampling)."""
    if k == 1:
        return x
    *lead, h, w, c = x.shape
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    up = F.interpolate(nchw, scale_factor=k, mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).reshape(*lead, h * k, w * k, c)


def upsample(x: torch.Tensor, k: int, mode: str = "nearest") -> torch.Tensor:
    if mode == "nearest":
        return upsample_nearest(x, k)
    if mode == "bilinear":
        return upsample_bilinear(x, k)
    raise ValueError(f"unknown upsample mode {mode!r}")


def repeat_interleave_2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Lift LR statistics to the HR grid (identical to nearest upsampling)."""
    return upsample_nearest(x, k)
