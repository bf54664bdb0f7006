"""Non-U-Net downscaling baselines (port of ``probunet_tpu/models/baselines.py``).

- :class:`LinearCNN`: two stacked 3x3 SAME convs, a linear-capacity CNN
  baseline, with the Flax module's names (``first_conv``,
  ``second_conv``);
- :func:`bcsd`: Bias-Corrected Statistical Downscaling, the interpolated
  LR field scaled by the training years' day-of-year HR / LR-interp
  climatology ratio, in torch on the tensors' device.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _lecun_normal(shape: tuple[int, ...], fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """N(0, 1/fan_in) (Flax's default conv init without its truncation)."""
    return torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)


class LinearCNN(nn.Module):
    """(B, H, W, input_channels) -> (B, H, W, in_channels) through
    ``latent_channels``, in the input's dtype (the JAX module's
    ``in_channels`` is its output width, as in the reference; Flax infers
    the input width, which the port takes as ``input_channels``, by
    default ``in_channels``)."""

    def __init__(self, in_channels: int, latent_channels: int = 10, *,
                 generator: torch.Generator, input_channels: int | None = None):
        super().__init__()
        cin = in_channels if input_channels is None else input_channels
        self.first_conv = nn.Conv2d(cin, latent_channels, 3, padding=1)
        self.second_conv = nn.Conv2d(latent_channels, in_channels, 3, padding=1)
        with torch.no_grad():
            for conv in (self.first_conv, self.second_conv):
                fan_in = conv.in_channels * 9
                conv.weight.copy_(_lecun_normal(tuple(conv.weight.shape), fan_in, generator))
                conv.bias.zero_()

    dropout_blocks: list[str] = []     # no dropout

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train``, ``seeds`` and ``generator`` are taken for the U-Nets'
        signature; the model has no dropout."""
        return self.second_conv(self.first_conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def bcsd(train_hr: torch.Tensor, train_lrinterp: torch.Tensor, test_lrinterp: torch.Tensor,
         epsilon: float = 1e-9, days_per_year: int = 365) -> torch.Tensor:
    """BCSD baseline. train_hr / train_lrinterp: (T_train, H, W, C);
    test_lrinterp: (T_test, H, W, C). Over the last n = min(train years,
    test years) * days_per_year training days, the day-of-year mean of HR
    over those years is divided by each year's lrinterp regrouped by day
    of year, and the test lrinterp's first n days are scaled by it (the
    reference's climatology-numerator / per-year-denominator
    construction). Needs whole years on both sides: fewer than one gives
    an empty result."""
    train_years = train_hr.shape[0] // days_per_year
    test_years = test_lrinterp.shape[0] // days_per_year
    years = min(train_years, test_years)
    n = years * days_per_year
    rest = tuple(train_hr.shape[1:])
    hr = train_hr[train_hr.shape[0] - n:]
    den = train_lrinterp[train_lrinterp.shape[0] - n:]
    clim = hr.reshape(years, days_per_year, *rest).mean(dim=0)      # (365, H, W, C)
    num = clim.repeat(years, *([1] * len(rest)))
    den_regrouped = den.reshape(years, days_per_year, *rest).transpose(0, 1).reshape(n, *rest)
    scale = num / (den_regrouped + epsilon)
    test = test_lrinterp[:n]
    return test * scale[: test.shape[0]]
