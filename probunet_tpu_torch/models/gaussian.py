"""Axis-aligned convolutional Gaussian prior/posterior encoder (port of
``probunet_tpu/models/gaussian.py``).

Per filter level: [2x2 max pool +] 3 x (conv3x3 + ReLU); then a global
average pool and two 1x1 convs giving (mu, log_sigma), returned in f32 as
a :class:`DiagGaussian`. The posterior concatenates the target onto the
input channels. Init: kaiming-normal (fan-in, ReLU) weights and
truncated-normal(0.001) biases. ``save_convs=True`` (the JAX package's
``remat="save_convs_all"``) runs the encoder under selective
checkpointing while autograd records: conv outputs are stored, the ReLU
and pooling chains recomputed in the backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probunet_tpu_torch.models.layers import save_convs_checkpoint
from probunet_tpu_torch.ops.distributions import DiagGaussian


def kaiming_relu_init(shape: tuple[int, ...], fan_in: int,
                      generator: torch.Generator) -> torch.Tensor:
    """std = sqrt(2 / fan_in) normal draws."""
    return (2.0 / fan_in) ** 0.5 * torch.randn(shape, generator=generator,
                                               device=generator.device)


def trunc_normal_bias_init(shape: tuple[int, ...], generator: torch.Generator,
                           std: float = 0.001) -> torch.Tensor:
    """Truncated normal in (-2, 2) scaled by ``std``."""
    t = torch.empty(shape, device=generator.device)
    return std * nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)


class _Conv3x3(nn.Module):
    """k x k conv (OIHW weight) + bias, computed in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, *,
                 generator: torch.Generator, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        fan_in = kernel * kernel * in_channels
        self.weight = nn.Parameter(kaiming_relu_init(
            (features, in_channels, kernel, kernel), fan_in, generator))
        self.bias = nn.Parameter(trunc_normal_bias_init((features,), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else x.dtype
        k = self.weight.shape[-1]
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding=k // 2)
        return (y + self.bias[:, None, None]).to(x.dtype)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, VALID (odd trailing row/column dropped)."""
    return F.max_pool2d(x, 2)


class AxisAlignedConvGaussian(nn.Module):
    """(B, H, W, C) [+ target (B, H, W, K) for the posterior] -> DiagGaussian
    with (B, latent_dim) f32 mu and log_sigma."""

    def __init__(self, in_channels: int, num_filters: Sequence[int], latent_dim: int, *,
                 generator: torch.Generator, posterior: bool = False,
                 dtype: torch.dtype | None = None, save_convs: bool = False):
        super().__init__()
        self.posterior, self.dtype, self.save_convs = posterior, dtype, save_convs
        self.levels = len(num_filters)
        kw = dict(generator=generator, dtype=dtype)
        cin = in_channels
        for i, filters in enumerate(num_filters):
            for j in range(3):
                self.add_module(f"enc{i}_conv{j}", _Conv3x3(cin, filters, **kw))
                cin = filters
        self.conv_mu = _Conv3x3(cin, latent_dim, 1, **kw)
        self.conv_log_sigma = _Conv3x3(cin, latent_dim, 1, **kw)

    def forward(self, x: torch.Tensor, target: torch.Tensor | None = None) -> DiagGaussian:
        if self.save_convs and torch.is_grad_enabled():
            mu, log_sigma = save_convs_checkpoint(self._moments, x, target)
        else:
            mu, log_sigma = self._moments(x, target)
        return DiagGaussian(mu=mu, log_sigma=log_sigma)

    def _moments(self, x: torch.Tensor, target: torch.Tensor | None):
        if self.posterior and target is not None:
            x = torch.cat([x, target.to(x.dtype)], dim=-1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = x.permute(0, 3, 1, 2)
        for i in range(self.levels):
            if i != 0:
                h = _max_pool2(h)
            for j in range(3):
                h = torch.relu(self.get_submodule(f"enc{i}_conv{j}")(h))
        h = h.mean(dim=(2, 3), keepdim=True)  # global average pool
        return (self.conv_mu(h)[:, :, 0, 0].float(),
                self.conv_log_sigma(h)[:, :, 0, 0].float())
