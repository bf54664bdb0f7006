"""Spatial resampling on channels-last fields (port of
``probunet_tpu/ops/resample.py``).

All functions take ``(..., H, W, C)`` tensors and integer factors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from probunet_tpu_torch.ops.kernels.avg_pool import window_mean


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean over the (-3, -2) axes (like
    ``nn.AvgPool2d(kernel_size=k)``), in the JAX package's order of
    additions: each window's terms added in row-major order, the sum times
    f32(1 / k^2). The plain version for a CPU tensor, kernel G for a CUDA
    tensor (``ops/kernels/avg_pool.py``)."""
    if k == 1:
        return x
    return window_mean(x, k)


def upsample_nearest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Nearest-neighbour k-times upsampling over the (-3, -2) axes."""
    if k == 1:
        return x
    return x.repeat_interleave(k, dim=-3).repeat_interleave(k, dim=-2)


def upsample_bilinear(x: torch.Tensor, k: int, rows=None) -> torch.Tensor:
    """Bilinear k-times upsampling with half-pixel centres
    (``align_corners=False``, the same sampling as ``jax.image.resize``'s
    'linear' when upsampling).

    ``rows`` (``parallel.spatial.Rows``): x is this rank's block of the
    image's rows (at x's resolution). The block takes one row of each
    neighbour (none at the image's top and bottom, where the interpolation
    clamps to the edge row as unsharded), is upsampled, and the k rows
    each neighbour's row gave are cropped. The padded block's source
    coordinates differ from the image's by a whole number of rows, so the
    kept rows are the image's rows bit for bit where 1 / k is exact."""
    if k == 1:
        return x
    top = bottom = 0
    if rows is not None:
        top, bottom = int(rows.index > 0), int(rows.index < rows.parts - 1)
        h = x.shape[-3]
        x = rows.halo(x, 1, row_axis=-3).narrow(-3, 1 - top, h + top + bottom)
    *lead, h, w, c = x.shape
    nchw = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    up = F.interpolate(nchw, scale_factor=k, mode="bilinear", align_corners=False)
    up = up.permute(0, 2, 3, 1).reshape(*lead, h * k, w * k, c)
    return up.narrow(-3, top * k, (h - top - bottom) * k)


def upsample(x: torch.Tensor, k: int, mode: str = "nearest", rows=None) -> torch.Tensor:
    """``mode`` "nearest" or "bilinear" k-times upsampling; ``rows``: x is
    a block of image rows (nearest needs no other rows)."""
    if mode == "nearest":
        return upsample_nearest(x, k)
    if mode == "bilinear":
        return upsample_bilinear(x, k, rows)
    raise ValueError(f"unknown upsample mode {mode!r}")


def repeat_interleave_2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Lift LR statistics to the HR grid (identical to nearest upsampling)."""
    return upsample_nearest(x, k)
