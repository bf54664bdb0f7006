"""Fcomb: combine U-Net features with a latent sample (port of
``probunet_tpu/models/fcomb.py``).

A 3-layer 1x1-conv MLP (ReLU, ReLU, linear) on [features ; tiled z],
computed in the split form ``feats @ W_f + z @ W_z + b`` so no tiled-z
concat exists. Weights are stored as (cin, cout) matrices. With a bf16
compute dtype the operands of each product are rounded to bf16 and
accumulate in f32; ``h`` and ``out`` are cast to the feature dtype, the
JAX module's rounding points.
"""

from __future__ import annotations

import torch
from torch import nn

from probunet_tpu_torch.models.gaussian import kaiming_relu_init, trunc_normal_bias_init
from probunet_tpu_torch.ops.precision import matmul_f32


class Fcomb(nn.Module):
    def __init__(self, unet_output_channels: int, latent_dim: int, num_classes: int, *,
                 generator: torch.Generator, dtype: torch.dtype | None = None):
        super().__init__()
        c, d, k = unet_output_channels, latent_dim, num_classes
        self.channels, self.dtype = c, dtype

        def weight(cin, cout):  # fan-in of the (1, 1, cin, cout) conv
            return nn.Parameter(kaiming_relu_init((cin, cout), cin, generator))

        def bias(n):
            return nn.Parameter(trunc_normal_bias_init((n,), generator))

        self.layer0_weight, self.layer0_bias = weight(c + d, c), bias(c)
        self.layer1_weight, self.layer1_bias = weight(c, c), bias(c)
        self.layer2_weight, self.layer2_bias = weight(c, k), bias(k)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return matmul_f32(x, w, self.dtype if self.dtype is not None else x.dtype)

    def _head(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Layers 1-2 after the layer-0 pre-activation ``h``."""
        h = torch.relu(h.to(dtype))
        h = torch.relu((self._mm(h, self.layer1_weight) + self.layer1_bias).to(dtype))
        return (self._mm(h, self.layer2_weight) + self.layer2_bias).to(dtype)

    def forward(self, feature_map: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """feature_map (B, H, W, C), z (B, D) -> (B, H, W, num_classes)."""
        c = self.channels
        w0 = self.layer0_weight
        h = self._mm(feature_map, w0[:c]) + (
            self._mm(z, w0[c:]) + self.layer0_bias)[:, None, None, :]
        return self._head(h, feature_map.dtype)

    def ensemble(self, feature_map: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
        """feature_map (B, H, W, C), zs (M, B, D) -> (B, M, H, W, num_classes),
        the feature projection computed once for all members."""
        c = self.channels
        w0 = self.layer0_weight
        feat_part = self._mm(feature_map, w0[:c])                   # (B, H, W, C)
        z_part = self._mm(zs, w0[c:]) + self.layer0_bias            # (M, B, C)
        h = feat_part[None] + z_part[:, :, None, None, :]           # (M, B, H, W, C)
        return self._head(h, feature_map.dtype).transpose(0, 1)
