"""EDM preconditioning wrapper (port of ``probunet_tpu/models/edm.py``).

:class:`EDMPrecond` wraps the diffusion U-Net (``UNet(use_diffuse=True)``)
with the EDM scalings of Karras et al. 2022, computed in f32 from a (B,)
noise level sigma:

    c_skip = sd^2 / (sigma^2 + sd^2)      c_out = sigma sd / sqrt(sigma^2 + sd^2)
    c_in = 1 / sqrt(sd^2 + sigma^2)       c_noise = log(sigma) / 4

    D(x; sigma) = c_skip x + c_out F((c_in [x; condition]) in x's type; c_noise)

with sd = ``sigma_data`` and the optional conditioning image concatenated
after x on the channel axis (NHWC). Unlike the JAX module, whose Flax
U-Net infers its input width, ``in_channels`` is the U-Net's input width:
x's channels plus the condition's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from probunet_tpu_torch.models.unet import UNet


class EDMPrecond(nn.Module):
    """NHWC in and out: (x (B, H, W, out_channels), sigma (B,)) -> the
    denoised (B, H, W, out_channels). The U-Net is the ``model`` submodule
    (the JAX tree's ``model/...``)."""

    def __init__(self, img_resolution: Sequence[int], in_channels: int, out_channels: int,
                 *, generator: torch.Generator, label_dim: int = 0, sigma_min: float = 0.0,
                 sigma_max: float = float("inf"), sigma_data: float = 1.0,
                 model_channels: int = 64, channel_mult: Sequence[int] = (1, 2, 3, 4),
                 num_blocks: int = 2, dropout: float = 0.10, use_diffuse: bool = True,
                 dtype: torch.dtype | None = None, gn_impl: str = "kernel", remat=False,
                 act_compress: bool = False):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.sigma_min, self.sigma_max, self.sigma_data = sigma_min, sigma_max, sigma_data
        self.model = UNet(tuple(img_resolution), in_channels, out_channels,
                          generator=generator, label_dim=label_dim,
                          model_channels=model_channels, channel_mult=tuple(channel_mult),
                          num_blocks=num_blocks, dropout=dropout, use_diffuse=use_diffuse,
                          dtype=dtype, gn_impl=gn_impl, remat=remat,
                          act_compress=act_compress)

    @property
    def dropout_blocks(self) -> list[str]:
        return self.model.dropout_blocks

    def forward(self, x: torch.Tensor, sigma: torch.Tensor,
                condition_img: torch.Tensor | None = None,
                class_labels: torch.Tensor | None = None, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                label_keep: torch.Tensor | None = None) -> torch.Tensor:
        """``seeds``/``generator``/``label_keep``: the U-Net's dropout seed
        words and label-dropout mask (``UNet.forward``)."""
        in_img = x if condition_img is None else torch.cat([x, condition_img], dim=-1)
        if in_img.shape[-1] != self.in_channels:
            raise ValueError(f"the U-Net takes {self.in_channels} channels, x and the "
                             f"condition give {in_img.shape[-1]}")
        sigma = sigma.reshape(-1, 1, 1, 1).float()
        sd = self.sigma_data
        c_skip = sd ** 2 / (sigma ** 2 + sd ** 2)
        c_out = sigma * sd / torch.sqrt(sigma ** 2 + sd ** 2)
        c_in = 1.0 / torch.sqrt(sd ** 2 + sigma ** 2)
        c_noise = torch.log(sigma) / 4.0
        f_x = self.model((c_in * in_img).to(x.dtype), train, seeds, generator,
                         noise_labels=c_noise.reshape(-1), class_labels=class_labels,
                         label_keep=label_keep)
        return c_skip * x + c_out * f_x
