"""Probabilistic U-Net (port of ``probunet_tpu/models/prob_unet.py``):
U-Net backbone + prior/posterior Gaussians + Fcomb.

Ported: ``sample`` (prior ensemble with shared U-Net features),
``encode``, ``decode`` and the afCRPS / CRPS branches of ``elbo``, for
evaluation and for training (``training=True``: U-Net dropout on,
gradients through both reconstruction routes). Every random draw takes an
explicit ``torch.Generator`` or the values themselves (the posterior
noise ``eps``, the dropout seed words ``seeds``), since JAX's and torch's
generators never give the same numbers.

The ELBO's reconstruction runs fused by default — Fcomb decode and CRPS
terms in one pass (``ops.kernels.fcomb_crps``: the CUDA kernel for CUDA
tensors, its plain version on the CPU). ``fused=False`` materializes the
ensemble with ``Fcomb.ensemble`` and scores it with ``afcrps_loss`` /
``crps_loss`` (``ops.kernels.afcrps``), like ``PROBUNET_FUSED_ELBO=0`` in
the JAX package.

``gn_impl`` picks the U-Net's GroupNorm-chain route (kernels C/C′, the
default, or the torch composition with kernel D; ``layers.EDMGroupNorm``)
and ``remat`` its gradient rematerialization (``models/unet.py``);
``remat="save_convs_all"`` also checkpoints the prior and posterior
encoders, storing their conv outputs. Neither changes the results.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.models.fcomb import Fcomb
from probunet_tpu_torch.models.gaussian import AxisAlignedConvGaussian
from probunet_tpu_torch.models.unet import UNet
from probunet_tpu_torch.ops.distributions import kl_diag_gaussians
from probunet_tpu_torch.ops.kernels import fcomb_crps
from probunet_tpu_torch.ops.losses import afcrps_loss, crps_loss

LOSS_TYPES = ("afcrps", "crps", "mse+ssim", "l1")


class ProbabilisticUNet(nn.Module):
    def __init__(self, *, generator: torch.Generator, input_channels: int = 3,
                 num_classes: int = 3, latent_dim: int = 32,
                 num_filters: Sequence[int] = (32, 64, 128, 256), model_channels: int = 32,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 img_resolution: Sequence[int] = (128, 128), num_blocks: int = 2,
                 dropout: float = 0.10, dtype: torch.dtype | None = None,
                 gn_impl: str = "kernel", remat=False):
        super().__init__()
        self.dtype = dtype
        kw = dict(generator=generator, dtype=dtype)
        self.unet = UNet(tuple(img_resolution), input_channels, num_filters[0],
                         model_channels=model_channels,
                         channel_mult=tuple(channel_mult), num_blocks=num_blocks,
                         dropout=dropout, gn_impl=gn_impl, remat=remat, **kw)
        save_convs = remat == "save_convs_all"
        self.prior = AxisAlignedConvGaussian(input_channels, num_filters, latent_dim,
                                             posterior=False, save_convs=save_convs, **kw)
        self.posterior = AxisAlignedConvGaussian(input_channels + num_classes, num_filters,
                                                 latent_dim, posterior=True,
                                                 save_convs=save_convs, **kw)
        self.fcomb = Fcomb(num_filters[0], latent_dim, num_classes, **kw)

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator,
                    device: str | torch.device | None = "cuda",
                    gn_impl: str = "kernel") -> "ProbabilisticUNet":
        """The model of a ``probunet_tpu_torch.config.Config`` (as the JAX
        CLI's ``make_model`` builds it, with ``remat =
        tuple(cfg.train.remat_levels) or cfg.train.remat``), initialized
        from ``generator`` on its device and moved to ``device`` (the CUDA
        device unless the caller passes ``device="cpu"``; raises without
        one). ``gn_impl``: the GroupNorm chains' route."""
        dev = resolve_device(device)
        m = cfg.model
        return cls(generator=generator, input_channels=m.input_channels,
                   num_classes=m.num_classes, latent_dim=m.latent_dim,
                   num_filters=m.num_filters, model_channels=m.model_channels,
                   channel_mult=m.channel_mult, img_resolution=cfg.data.resolution,
                   num_blocks=m.num_blocks, dropout=m.dropout,
                   dtype=torch.bfloat16 if m.compute_dtype == "bfloat16" else None,
                   gn_impl=gn_impl,
                   remat=tuple(cfg.train.remat_levels) or cfg.train.remat).to(dev)

    def sample(self, x: torch.Tensor, num_samples: int = 1,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None) -> torch.Tensor:
        """Prior ensemble with shared U-Net features: (B, M, H, W, K)."""
        feats = self.unet(x)
        zs = self.prior(x).rsample(generator, (num_samples,), eps)
        return self.fcomb.ensemble(feats, zs)

    def encode(self, x: torch.Tensor, target: torch.Tensor | None = None):
        """(features, prior, posterior-or-None)."""
        feats = self.unet(x)
        prior = self.prior(x)
        post = self.posterior(x, target) if target is not None else None
        return feats, prior, post

    def decode(self, feats: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
        """Fcomb-only decode: zs (B, D) -> (B, H, W, K); (M, B, D) ->
        (B, M, H, W, K)."""
        if zs.dim() == 2:
            return self.fcomb(feats, zs)
        return self.fcomb.ensemble(feats, zs)

    def elbo(self, x: torch.Tensor, target: torch.Tensor, M: int = 1,
             loss_type: str = "afcrps", beta_0: float = 1.0, beta_1: float = 0.0,
             alpha: float = 0.95, generator: torch.Generator | None = None,
             eps: torch.Tensor | None = None, fused: bool = True,
             training: bool = False, seeds: torch.Tensor | None = None):
        """ELBO = beta_0 * recon + beta_1 * KL(q || p), with M posterior
        draws (noise ``eps`` (M, B, D) or drawn from ``generator``).

        ``training``: the U-Net's dropout on, its seed words ``seeds``
        ((n_blocks, 2) int32, block order) or drawn from ``generator``
        first, before the noise. Unlike the JAX method, the default is
        False (evaluation). Differentiable on both routes: fused (kernels
        A and A′) and unfused (``Fcomb.ensemble``, kernels B and B′).
        ``fused`` takes the unfused route where kernel A does not take the
        shape (``fcomb_crps.supported``: Fcomb width other than 32, M above
        32, more than 4 classes), on the CPU as on the card.

        Returns (total, metrics) with metrics {"recon", "kl", "kl_mean"}.
        """
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        if loss_type not in ("afcrps", "crps"):
            raise NotImplementedError(f"the {loss_type!r} ELBO is not ported yet")
        if M < 2:
            raise ValueError(f"M must be >= 2 for {loss_type}, got {M}")
        feats = self.unet(x, train=training, seeds=seeds, generator=generator)
        prior = self.prior(x)
        posterior = self.posterior(x, target)
        kl = kl_diag_gaussians(posterior, prior)                    # (B,)
        zs = posterior.rsample(generator, (M,), eps)                # (M, B, D)
        if fused and fcomb_crps.supported(self.fcomb.channels, M, target.shape[-1],
                                          target.shape[0]):
            params = dict(self.fcomb.named_parameters())
            recon = fcomb_crps.fused_fcomb_crps_loss(
                feats, zs, params, target, loss_type, alpha,
                "bfloat16" if self.dtype == torch.bfloat16 else "float32")
        else:
            ensemble = self.fcomb.ensemble(feats, zs)               # (B, M, H, W, K)
            recon = (afcrps_loss(ensemble, target, alpha=alpha) if loss_type == "afcrps"
                     else crps_loss(ensemble, target))
        total = beta_0 * recon + beta_1 * kl.mean()
        return total, {"recon": recon, "kl": kl, "kl_mean": kl.mean()}
