"""Tensor ops: resampling, diagonal-Gaussian math, the ELBOs' losses,
SSIM / MS-SSIM, and the hand-written CUDA kernels (``ops.kernels``) with
their plain versions."""

from probunet_tpu_torch.ops.resample import (
    avg_pool,
    upsample_nearest,
    upsample_bilinear,
    upsample,
    repeat_interleave_2d,
)
from probunet_tpu_torch.ops.distributions import DiagGaussian, kl_diag_gaussians
from probunet_tpu_torch.ops.losses import (
    afcrps_loss,
    afcrps_loss_pairwise,
    crps_loss,
    crps_loss_pairwise,
    crps_empirical,
    wmse_ms_ssim_loss,
    wmse_weights,
    l1_loss,
)
from probunet_tpu_torch.ops.msssim import ssim, ms_ssim

__all__ = [
    "avg_pool",
    "upsample_nearest",
    "upsample_bilinear",
    "upsample",
    "repeat_interleave_2d",
    "DiagGaussian",
    "kl_diag_gaussians",
    "afcrps_loss",
    "afcrps_loss_pairwise",
    "crps_loss",
    "crps_loss_pairwise",
    "crps_empirical",
    "wmse_ms_ssim_loss",
    "wmse_weights",
    "l1_loss",
    "ssim",
    "ms_ssim",
]
