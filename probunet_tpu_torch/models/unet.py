"""Symmetric ADM U-Net backbone (port of ``probunet_tpu/models/unet.py:UNet``).

``use_diffuse=False`` with the constant-zero label embedding: no labels
are passed, so a zero dummy flows through ``map_label`` and each block's
FiLM affine contributes only its learned bias. Submodules carry the JAX
package's names (``enc_128x128_conv``, ``dec_16x16_in0``, ...) so the
weight converter maps parameter paths one to one. No attention, no
dropout (the serve path runs neither).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from probunet_tpu_torch.models.layers import (
    INIT_EDM,
    INIT_ZERO,
    EDMConv,
    EDMGroupNorm,
    EDMLinear,
    UNetBlock,
)


class UNet(nn.Module):
    """NHWC in, NHWC out: (B, H, W, in_channels) -> (B, H, W, out_channels)."""

    def __init__(self, img_resolution: Sequence[int], in_channels: int, out_channels: int,
                 *, generator: torch.Generator, model_channels: int = 16,
                 channel_mult: Sequence[int] = (1, 4, 8, 16), channel_mult_emb: int = 4,
                 num_blocks: int = 2, dtype: torch.dtype | None = None):
        super().__init__()
        mc = model_channels
        self.dtype = dtype
        self.emb_channels = emb = mc * channel_mult_emb
        kw = dict(generator=generator, dtype=dtype)

        def block(name, cin, cout, **extra):
            self.add_module(name, UNetBlock(cin, cout, emb, **kw, **extra))

        # label_dim = 1: the zero dummy label of the reference's current stack
        self.map_label = EDMLinear(1, emb, use_bias=False, init=("kaiming_normal", 1.0, 0.0),
                                   generator=generator)
        # encoder: (name, pushes a skip); channels tracked as in the JAX module
        self.encoder: list[str] = []
        skip_ch = []
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            rx, ry = img_resolution[0] >> level, img_resolution[1] >> level
            if level == 0:
                name = f"enc_{rx}x{ry}_conv"
                self.add_module(name, EDMConv(in_channels, mc * mult, 3, init=INIT_EDM, **kw))
                cout = mc * mult
            else:
                name = f"enc_{rx}x{ry}_down"
                block(name, cout, cout, down=True)
            self.encoder.append(name)
            skip_ch.append(cout)
            for idx in range(num_blocks):
                name = f"enc_{rx}x{ry}_block{idx}"
                block(name, cout, mc * mult)
                cout = mc * mult
                self.encoder.append(name)
                skip_ch.append(cout)

        # decoder: (name, pops a skip)
        self.decoder: list[tuple[str, bool]] = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            rx, ry = img_resolution[0] >> level, img_resolution[1] >> level
            if level == len(channel_mult) - 1:
                for name in (f"dec_{rx}x{ry}_in0", f"dec_{rx}x{ry}_in1"):
                    block(name, cout, cout)
                    self.decoder.append((name, False))
            else:
                name = f"dec_{rx}x{ry}_up"
                block(name, cout, cout, up=True)
                self.decoder.append((name, False))
            for idx in range(num_blocks + 1):
                name = f"dec_{rx}x{ry}_block{idx}"
                block(name, cout + skip_ch.pop(), mc * mult)
                cout = mc * mult
                self.decoder.append((name, True))
        self.out_norm = EDMGroupNorm(cout, dtype=dtype)
        self.out_conv = EDMConv(cout, out_channels, 3, init=INIT_ZERO, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        b = x.shape[0]
        labels = torch.zeros((b, 1), dtype=x.dtype, device=x.device)
        emb = torch.zeros((b, self.emb_channels), dtype=x.dtype, device=x.device)
        emb = F.silu(emb + self.map_label(labels))

        h = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        skips = []
        for name in self.encoder:
            mod = self.get_submodule(name)
            h = mod(h) if isinstance(mod, EDMConv) else mod(h, emb)
            skips.append(h)
        for name, takes_skip in self.decoder:
            h = self.get_submodule(name)(h, emb, skips.pop() if takes_skip else None)
        h = self.out_conv(self.out_norm(h, silu=True))
        return h.permute(0, 2, 3, 1).to(out_dtype)
