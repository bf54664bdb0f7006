"""Axis-aligned convolutional Gaussian prior/posterior encoder (port of
``probunet_tpu/models/gaussian.py``).

Per filter level: [2x2 max pool +] 3 x (conv3x3 + ReLU); then a global
average pool and two 1x1 convs giving (mu, log_sigma), returned in f32 as
a :class:`DiagGaussian`. The posterior concatenates the target onto the
input channels. Init: kaiming-normal (fan-in, ReLU) weights and
truncated-normal(0.001) biases. The convolutions carry the int8 serving
hooks (``ops.quantize``). ``save_convs=True`` (the JAX package's
``remat="save_convs_all"``) runs the encoder under selective
checkpointing while autograd records: conv outputs are stored, the ReLU
and pooling chains recomputed in the backward. ``rows``
(``parallel.spatial.Rows``): the input is this rank's block of image
rows; the 3x3 convolutions halo-exchange one row, the max pools stay
local, and mu and log sigma are alike on every rank. The global average
pool on the card is the block's sum summed over the ranks ((B, C) a
rank) and divided by the global pixel count; on the CPU the ranks gather
the image's map ((B, C, height, W) a rank) and take the one-process mean
of it, exactly, as the split plain GroupNorm gathers its image
(``ops/kernels/fused_gn.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probunet_tpu_torch.models.layers import halo_rows, save_convs_checkpoint
from probunet_tpu_torch.ops import quantize
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
    """k x k conv (OIHW weight) + bias, computed in ``dtype``; the int8
    serving hooks of ``layers.EDMConv`` (``ops.quantize``)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, *,
                 generator: torch.Generator, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        fan_in = kernel * kernel * in_channels
        self.weight = nn.Parameter(kaiming_relu_init(
            (features, in_channels, kernel, kernel), fan_in, generator))
        self.bias = nn.Parameter(trunc_normal_bias_init((features,), generator))
        self.quant_scales = None

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """``rows``: x is this rank's block of rows, halo-exchanged first."""
        quantize.observe(self, x)
        k = self.weight.shape[-1]
        halo = k // 2 if rows is not None else 0
        h = x.shape[2]
        if halo:
            x = halo_rows(x, halo, rows)
        if quantize.takes_int8(self, False):
            y = quantize.int8_forward(self, x)
            if halo:   # E pads SAME: the halo rows' outputs are cropped
                y = y[:, :, halo:halo + h].contiguous(memory_format=torch.channels_last)
            return y
        dt = self.dtype if self.dtype is not None else x.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding=(0, k // 2) if halo else k // 2)
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

    def forward(self, x: torch.Tensor, target: torch.Tensor | None = None,
                rows=None) -> DiagGaussian:
        """``rows``: x (and target) are this rank's block of image rows."""
        if self.save_convs and torch.is_grad_enabled():
            mu, log_sigma = save_convs_checkpoint(self._moments, x, target, rows=rows)
        else:
            mu, log_sigma = self._moments(x, target, rows)
        return DiagGaussian(mu=mu, log_sigma=log_sigma)

    def _moments(self, x: torch.Tensor, target: torch.Tensor | None, rows=None):
        if self.posterior and target is not None:
            x = torch.cat([x, target.to(x.dtype)], dim=-1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = x.permute(0, 3, 1, 2)
        for i in range(self.levels):
            if i != 0:
                h = _max_pool2(h)
            for j in range(3):
                h = torch.relu(self.get_submodule(f"enc{i}_conv{j}")(h, rows=rows))
        if rows is None:
            h = h.mean(dim=(2, 3), keepdim=True)  # global average pool
        elif h.device.type == "cpu":
            # the image gathered: the block placed at its rows among zero rows
            # and summed over the ranks (each element one block's value plus
            # zeros: exact), so the mean is the one-process mean bit for bit
            h0, height = rows.first(h.shape[2]), rows.whole(h.shape[2])
            h = rows.sum(F.pad(h.float(), (0, 0, h0, height - h0 - h.shape[2]))).to(h.dtype)
            h = h.mean(dim=(2, 3), keepdim=True)
        else:   # the block's sum over the ranks, over the global pixel count
            total = rows.sum(h.sum(dim=(2, 3), keepdim=True, dtype=torch.float32))
            h = (total / (rows.whole(h.shape[2]) * h.shape[3])).to(h.dtype)
        return (self.conv_mu(h)[:, :, 0, 0].float(),
                self.conv_log_sigma(h)[:, :, 0, 0].float())
