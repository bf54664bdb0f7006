"""Probabilistic U-Net (port of ``probunet_tpu/models/prob_unet.py``):
U-Net backbone + prior/posterior Gaussians + Fcomb.

Ported: ``sample`` (prior ensemble with shared U-Net features),
``encode``, ``decode`` and the four branches of ``elbo`` (afCRPS, CRPS,
WMSE + MS-SSIM, L1), for evaluation and for training
(``training=True``: U-Net dropout on, gradients through both
reconstruction routes). Every random draw takes an
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
``act_compress`` keeps the U-Net's convolution inputs for the backward as
per-channel int8 (``ops.act_compress``; the JAX package under
``PROBUNET_ACT_COMPRESS=int8``): the loss is unchanged, the weight
gradients see the int8 error.

``rows`` (``parallel.spatial.Rows``, the spatially sharded step) places
x and the target as this rank's block of image rows: the U-Net and both
encoders run on the block (``models/layers.py``, ``models/gaussian.py``),
each reconstruction loss sums the block's terms over the ranks and
divides by the global count (``ops/losses.py``; MS-SSIM's windows through
a halo exchange a scale, ``ops/msssim.py``), and the KL of the
replicated Gaussians counts once.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.models.fcomb import Fcomb
from probunet_tpu_torch.models.gaussian import AxisAlignedConvGaussian
from probunet_tpu_torch.models.unet import UNet
from probunet_tpu_torch.ops.distributions import kl_diag_gaussians, kl_to_standard_normal
from probunet_tpu_torch.ops.kernels import fcomb_crps
from probunet_tpu_torch.ops.losses import (
    afcrps_loss,
    crps_loss,
    l1_loss,
    l1_loss_per_channel,
    wmse_ms_ssim_loss,
)
from probunet_tpu_torch.utils.profiling import span

LOSS_TYPES = ("afcrps", "crps", "mse+ssim", "l1")


class ProbabilisticUNet(nn.Module):
    def __init__(self, *, generator: torch.Generator, input_channels: int = 3,
                 num_classes: int = 3, latent_dim: int = 32,
                 num_filters: Sequence[int] = (32, 64, 128, 256), model_channels: int = 32,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 img_resolution: Sequence[int] = (128, 128), num_blocks: int = 2,
                 dropout: float = 0.10, dtype: torch.dtype | None = None,
                 gn_impl: str = "kernel", remat=False, act_compress: bool = False):
        super().__init__()
        self.dtype = dtype
        kw = dict(generator=generator, dtype=dtype)
        self.unet = UNet(tuple(img_resolution), input_channels, num_filters[0],
                         model_channels=model_channels,
                         channel_mult=tuple(channel_mult), num_blocks=num_blocks,
                         dropout=dropout, gn_impl=gn_impl, remat=remat,
                         act_compress=act_compress, **kw)
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
                    gn_impl: str = "kernel", act_compress: bool = False
                    ) -> "ProbabilisticUNet":
        """The model of a ``probunet_tpu_torch.config.Config`` (as the JAX
        CLI's ``make_model`` builds it, with ``remat =
        tuple(cfg.train.remat_levels) or cfg.train.remat``), initialized
        from ``generator`` on its device and moved to ``device`` (the CUDA
        device unless the caller passes ``device="cpu"``; raises without
        one). ``gn_impl``: the GroupNorm chains' route; ``act_compress``:
        int8 saved convolution inputs."""
        dev = resolve_device(device)
        m = cfg.model
        return cls(generator=generator, input_channels=m.input_channels,
                   num_classes=m.num_classes, latent_dim=m.latent_dim,
                   num_filters=m.num_filters, model_channels=m.model_channels,
                   channel_mult=m.channel_mult, img_resolution=cfg.data.resolution,
                   num_blocks=m.num_blocks, dropout=m.dropout,
                   dtype=torch.bfloat16 if m.compute_dtype == "bfloat16" else None,
                   gn_impl=gn_impl, act_compress=act_compress,
                   remat=tuple(cfg.train.remat_levels) or cfg.train.remat).to(dev)

    def sample(self, x: torch.Tensor, num_samples: int = 1,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None, rows=None) -> torch.Tensor:
        """Prior ensemble with shared U-Net features: (B, M, H, W, K);
        ``rows``: x is this rank's block of rows, and so is the output."""
        with span("serve.sample"):
            feats = self.unet(x, rows=rows)
            zs = self.prior(x, rows=rows).rsample(generator, (num_samples,), eps)
            return self.fcomb.ensemble(feats, zs)

    def encode(self, x: torch.Tensor, target: torch.Tensor | None = None, rows=None):
        """(features, prior, posterior-or-None); ``rows``: x (and target)
        are this rank's block of rows, the features the block's."""
        feats = self.unet(x, rows=rows)
        prior = self.prior(x, rows=rows)
        post = self.posterior(x, target, rows=rows) if target is not None else None
        return feats, prior, post

    def decode(self, feats: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
        """Fcomb-only decode: zs (B, D) -> (B, H, W, K); (M, B, D) ->
        (B, M, H, W, K)."""
        if zs.dim() == 2:
            return self.fcomb(feats, zs)
        return self.fcomb.ensemble(feats, zs)

    @staticmethod
    def _slab_noise(posterior, slab: tuple[int, int], lead: tuple[int, ...],
                    generator: torch.Generator | None, eps: torch.Tensor | None):
        """The slab's rows of the global batch's noise ``eps``, or of one
        drawn from ``generator`` as ``rsample`` draws it for the global
        batch."""
        b0, b_total = slab
        if eps is None:
            if generator is None:
                raise ValueError("elbo needs a generator or eps")
            mu = posterior.mu
            eps = torch.randn((*lead, b_total, mu.shape[-1]), generator=generator,
                              device=mu.device, dtype=mu.dtype)
        return eps.narrow(-2, b0, posterior.mu.shape[0])

    def elbo(self, x: torch.Tensor, target: torch.Tensor, M: int = 1,
             loss_type: str = "afcrps", beta_0: float = 1.0, beta_1: float = 0.0,
             beta_2: float = 0.0, alpha: float = 0.95, alpha_w: float = 0.007,
             beta_w: float = 0.048, lam_w: float = 0.0,
             generator: torch.Generator | None = None, eps: torch.Tensor | None = None,
             fused: bool = True, training: bool = False,
             seeds: torch.Tensor | None = None, slab: tuple[int, int] | None = None,
             rows=None, data_range=None, mesh=None):
        """ELBO = beta_0 * recon + beta_1 * KL(q || p) [+ beta_2 * KL(q || N(0, I))
        for ``"l1"``], the posterior noise ``eps`` or drawn from
        ``generator``: (M, B, D) for the ensemble losses, (B, D) for
        ``"l1"`` (one draw).

        ``training``: the U-Net's dropout on, its seed words ``seeds``
        ((n_blocks, 2) int32, block order) or drawn from ``generator``
        first, before the noise. Unlike the JAX method, the default is
        False (evaluation). ``slab`` = (first row, global batch) places x in
        the global batch of a data-parallel step: its dropout masks are the
        global batch's rows (``layers.EDMGroupNorm``), and ``eps``, given
        or drawn, is the global batch's noise, of which x's rows are used.
        ``rows`` (``parallel.spatial.Rows``): x and target are this rank's
        block of image rows; the loss and metrics are the whole image's,
        alike on every rank of the axis. ``data_range``: MS-SSIM's, by
        default the target's max - min (at least 1e-5); a step over a mesh
        passes the global batch's, which ``rows`` requires. ``mesh``: that
        step's mesh, over which the U-Net's compressed convolutions take
        their absmax (``act_compress``).

        - ``"afcrps"`` / ``"crps"``: M >= 2 draws scored as an ensemble,
          fused (kernels A and A′) or unfused (``Fcomb.ensemble``, kernels
          B and B′). ``fused`` takes the unfused route where kernel A does
          not take the shape (``fcomb_crps.supported``: Fcomb width other
          than 32, M above 32, more than 4 classes), on the CPU as on the
          card.
        - ``"mse+ssim"``: M draws through ``Fcomb.ensemble``, each scored
          by WMSE + MS-SSIM on its own and averaged; metrics ``wmse`` and
          ``msssim`` are the last draw's, as the reference logs them.
        - ``"l1"``: one draw through ``Fcomb``; metrics
          ``recon_per_channel`` and ``kl2_mean``.

        Returns (total, metrics) with metrics {"recon", "kl", "kl_mean", ...}.
        """
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        if loss_type in ("afcrps", "crps") and M < 2:
            raise ValueError(f"M must be >= 2 for {loss_type}, got {M}")
        feats = self.unet(x, train=training, seeds=seeds, generator=generator, slab=slab,
                          rows=rows, mesh=mesh)
        prior = self.prior(x, rows=rows)
        posterior = self.posterior(x, target, rows=rows)
        kl = kl_diag_gaussians(posterior, prior)                    # (B,)
        if slab is not None:
            eps = self._slab_noise(posterior, slab, () if loss_type == "l1" else (M,),
                                   generator, eps)
        metrics = {}
        if loss_type in ("afcrps", "crps"):
            zs = posterior.rsample(generator, (M,), eps)            # (M, B, D)
            if fused and fcomb_crps.supported(self.fcomb.channels, M, target.shape[-1],
                                              target.shape[0]):
                params = dict(self.fcomb.named_parameters())
                recon = fcomb_crps.fused_fcomb_crps_loss(
                    feats, zs, params, target, loss_type, alpha,
                    "bfloat16" if self.dtype == torch.bfloat16 else "float32", rows=rows)
            else:
                ensemble = self.fcomb.ensemble(feats, zs)           # (B, M, H, W, K)
                recon = (afcrps_loss(ensemble, target, alpha=alpha, rows=rows)
                         if loss_type == "afcrps" else crps_loss(ensemble, target, rows=rows))
            total = beta_0 * recon + beta_1 * kl.mean()
        elif loss_type == "mse+ssim":
            if data_range is None and rows is None:   # one range for the M draws
                data_range = torch.clamp(target.max() - target.min(), min=1e-5)
            zs = posterior.rsample(generator, (M,), eps)
            ensemble = self.fcomb.ensemble(feats, zs)               # (B, M, H, W, K)
            per_draw = [wmse_ms_ssim_loss(ensemble[:, i], target, alpha=alpha_w,
                                          beta=beta_w, lam=lam_w, return_components=True,
                                          data_range=data_range, rows=rows)
                        for i in range(M)]
            recon = torch.stack([d[0] for d in per_draw]).mean()
            metrics["wmse"], metrics["msssim"] = per_draw[-1][1], per_draw[-1][2]
            total = beta_0 * recon + beta_1 * kl.mean()
        else:  # l1: one draw
            pred = self.fcomb(feats, posterior.rsample(generator, (), eps))
            recon = l1_loss(pred, target, rows)
            metrics["recon_per_channel"] = l1_loss_per_channel(pred, target, rows)
            kl2 = kl_to_standard_normal(posterior)
            metrics["kl2_mean"] = kl2.mean()
            total = beta_0 * recon + beta_1 * kl.mean() + beta_2 * kl2.mean()
        metrics.update(recon=recon, kl=kl, kl_mean=kl.mean())
        return total, metrics
