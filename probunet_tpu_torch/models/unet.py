"""Symmetric ADM U-Net backbone (port of ``probunet_tpu/models/unet.py:UNet``).

``use_diffuse=False`` with the constant-zero label embedding: no labels
are passed, so a zero dummy flows through ``map_label`` and each block's
FiLM affine contributes only its learned bias. Submodules carry the JAX
package's names (``enc_128x128_conv``, ``dec_16x16_in0``, ...) so the
weight converter maps parameter paths one to one. No attention.

``train=True`` turns on each block's dropout (kernel D). The JAX module's
``label_dropout`` is not ported: it only ever multiplies the all-zero dummy
label, and no configuration sets it. Every block takes its own (2,) int32 seed words: the caller
passes them as one (n_blocks, 2) tensor in block order (``dropout_blocks``)
or they are drawn from the caller's generator, as the JAX U-Net draws one
``dropout`` key per block.
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


def dropout_seeds(generator: torch.Generator | None, n: int) -> torch.Tensor:
    """(n, 2) int32 dropout seed words drawn from ``generator``, on its device."""
    if generator is None:
        raise ValueError("dropout needs seed words or a generator to draw them from")
    return torch.randint(-2 ** 31, 2 ** 31, (n, 2), generator=generator,
                         device=generator.device, dtype=torch.int32)


class UNet(nn.Module):
    """NHWC in, NHWC out: (B, H, W, in_channels) -> (B, H, W, out_channels)."""

    def __init__(self, img_resolution: Sequence[int], in_channels: int, out_channels: int,
                 *, generator: torch.Generator, model_channels: int = 16,
                 channel_mult: Sequence[int] = (1, 4, 8, 16), channel_mult_emb: int = 4,
                 num_blocks: int = 2, dropout: float = 0.10,
                 dtype: torch.dtype | None = None):
        super().__init__()
        mc = model_channels
        self.dtype = dtype
        self.dropout = dropout
        self.emb_channels = emb = mc * channel_mult_emb
        kw = dict(generator=generator, dtype=dtype)
        self.dropout_blocks: list[str] = []  # every UNetBlock, in call order

        def block(name, cin, cout, **extra):
            self.add_module(name, UNetBlock(cin, cout, emb, dropout=dropout, **kw, **extra))
            self.dropout_blocks.append(name)

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

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train``: dropout on. ``seeds``: (len(dropout_blocks), 2) int32
        seed words in block order; drawn from ``generator`` when None."""
        out_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        b = x.shape[0]
        block_seeds = {}
        if train and self.dropout > 0:
            if seeds is None:
                seeds = dropout_seeds(generator, len(self.dropout_blocks))
            if tuple(seeds.shape) != (len(self.dropout_blocks), 2):
                raise ValueError(f"seeds must be ({len(self.dropout_blocks)}, 2), got "
                                 f"{tuple(seeds.shape)}")
            block_seeds = dict(zip(self.dropout_blocks, seeds.to(x.device).unbind()))
        labels = torch.zeros((b, 1), dtype=x.dtype, device=x.device)
        emb = torch.zeros((b, self.emb_channels), dtype=x.dtype, device=x.device)
        emb = F.silu(emb + self.map_label(labels))

        def run(name, h, skip=None):
            return self.get_submodule(name)(h, emb, skip, train=train,
                                            drop_seed=block_seeds.get(name))

        h = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        skips = []
        for name in self.encoder:
            mod = self.get_submodule(name)
            h = mod(h) if isinstance(mod, EDMConv) else run(name, h)
            skips.append(h)
        for name, takes_skip in self.decoder:
            h = run(name, h, skips.pop() if takes_skip else None)
        h = self.out_conv(self.out_norm(h, silu=True))
        return h.permute(0, 2, 3, 1).to(out_dtype)
