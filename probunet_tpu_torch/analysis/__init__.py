"""Latent-space exploration and collapse diagnostics (port of
``probunet_tpu/analysis``): latent collection, PCA, grid decoding against
frozen U-Net features, the ten latent-collapse probes and the
single-sample prior sweep, as library functions behind ``explore``."""

from probunet_tpu_torch.analysis.latent import (
    LatentPCA,
    collapse_diagnostics,
    collect_latents,
    decode_latent_grid,
    format_summary,
    pc_grid_deciles,
    pc_grid_sigma,
    single_prior_sweep,
)

__all__ = [
    "collect_latents",
    "LatentPCA",
    "pc_grid_deciles",
    "pc_grid_sigma",
    "decode_latent_grid",
    "collapse_diagnostics",
    "format_summary",
    "single_prior_sweep",
]
