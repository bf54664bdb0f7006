"""Utilities: the figures (matplotlib imported when one is drawn),
profiling hooks and small training helpers."""

from probunet_tpu_torch.utils.misc import l2_regularization, moving_average
from probunet_tpu_torch.utils.plotting import (
    plot_batch,
    plot_histograms,
    plot_latent_grid,
    plot_latent_joint_marginal,
    plot_loss_curves,
    plot_psd,
    plot_residual_differences,
    plot_residual_sample_batch,
    plot_return_levels,
    plot_sample_batch,
    plot_seasonal_maps,
)

__all__ = [
    "plot_batch",
    "plot_sample_batch",
    "plot_residual_sample_batch",
    "plot_residual_differences",
    "plot_loss_curves",
    "plot_psd",
    "plot_histograms",
    "plot_return_levels",
    "plot_latent_grid",
    "plot_latent_joint_marginal",
    "plot_seasonal_maps",
    "l2_regularization",
    "moving_average",
]
