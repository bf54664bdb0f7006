"""Symmetric ADM U-Net backbone (port of ``probunet_tpu/models/unet.py:UNet``).

``use_diffuse=False`` with the constant-zero label embedding: no labels
are passed, so a zero dummy flows through ``map_label`` and each block's
FiLM affine contributes only its learned bias. Submodules carry the JAX
package's names (``enc_128x128_conv``, ``dec_16x16_in0``, ...) so the
weight converter maps parameter paths one to one. No attention.

``train=True`` turns on each block's dropout (in kernel C, or kernel D on
the composed route; ``gn_impl`` picks the GroupNorm chains' route, see
``layers.EDMGroupNorm``). The JAX module's ``label_dropout`` is not
ported: it only ever multiplies the all-zero dummy label, and no
configuration sets it. Every block takes its own (2,) int32 seed words:
the caller passes them as one (n_blocks, 2) tensor in block order
(``dropout_blocks``) or they are drawn from the caller's generator, as the
JAX U-Net draws one ``dropout`` key per block.

``remat`` is the JAX module's gradient rematerialization, applied while
autograd records:

- ``False``, ``None`` or ``()``: nothing is checkpointed;
- ``True``: every ``UNetBlock`` runs under ``torch.utils.checkpoint``
  (non-reentrant) and is recomputed whole in the backward;
- a tuple of level indices: only the blocks at those resolution levels;
- ``"save_convs"`` or ``"save_convs_all"``: every block runs under
  selective checkpointing that stores the conv outputs and recomputes the
  GroupNorm chains (``layers.save_convs_checkpoint``); ``"save_convs_all"``
  also covers the Gaussians (``ProbabilisticUNet``).

The seed words are tensors, so a recompute regenerates the same masks and
the loss and gradients are those of ``remat=False``. A recompute launches
the chain's kernels again, and their launch counters count it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from probunet_tpu_torch.models.layers import (
    INIT_EDM,
    INIT_ZERO,
    EDMConv,
    EDMGroupNorm,
    EDMLinear,
    UNetBlock,
    save_convs_checkpoint,
)

SAVE_CONVS = ("save_convs", "save_convs_all")


def block_remat(remat, level: int) -> str | None:
    """How a block at ``level`` is checkpointed under the U-Net's ``remat``
    setting: None, ``"full"`` or ``"save_convs"``. Raises on a setting the
    JAX module does not define."""
    if isinstance(remat, str):
        if remat not in SAVE_CONVS:
            raise ValueError(f"unknown remat mode {remat!r}")
        return "save_convs"
    if remat is True:
        return "full"
    if remat is None or remat is False:
        return None
    if isinstance(remat, (tuple, list)) and all(
            isinstance(v, int) and not isinstance(v, bool) for v in remat):
        return "full" if level in remat else None
    raise ValueError(f"remat must be a bool, None, a tuple of levels or one of {SAVE_CONVS}, "
                     f"got {remat!r}")


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
                 dtype: torch.dtype | None = None, gn_impl: str = "kernel", remat=False):
        super().__init__()
        mc = model_channels
        self.dtype = dtype
        self.dropout = dropout
        self.emb_channels = emb = mc * channel_mult_emb
        kw = dict(generator=generator, dtype=dtype)
        self.dropout_blocks: list[str] = []  # every UNetBlock, in call order
        self.block_remat: dict[str, str | None] = {}

        def block(name, cin, cout, level, **extra):
            self.add_module(name, UNetBlock(cin, cout, emb, dropout=dropout, gn_impl=gn_impl,
                                            **kw, **extra))
            self.dropout_blocks.append(name)
            self.block_remat[name] = block_remat(remat, level)

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
                block(name, cout, cout, level, down=True)
            self.encoder.append(name)
            skip_ch.append(cout)
            for idx in range(num_blocks):
                name = f"enc_{rx}x{ry}_block{idx}"
                block(name, cout, mc * mult, level)
                cout = mc * mult
                self.encoder.append(name)
                skip_ch.append(cout)

        # decoder: (name, pops a skip)
        self.decoder: list[tuple[str, bool]] = []
        for level, mult in reversed(list(enumerate(channel_mult))):
            rx, ry = img_resolution[0] >> level, img_resolution[1] >> level
            if level == len(channel_mult) - 1:
                for name in (f"dec_{rx}x{ry}_in0", f"dec_{rx}x{ry}_in1"):
                    block(name, cout, cout, level)
                    self.decoder.append((name, False))
            else:
                name = f"dec_{rx}x{ry}_up"
                block(name, cout, cout, level, up=True)
                self.decoder.append((name, False))
            for idx in range(num_blocks + 1):
                name = f"dec_{rx}x{ry}_block{idx}"
                block(name, cout + skip_ch.pop(), mc * mult, level)
                cout = mc * mult
                self.decoder.append((name, True))
        self.out_norm = EDMGroupNorm(cout, dtype=dtype, gn_impl=gn_impl)
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
            block = self.get_submodule(name)
            kw = dict(train=train, drop_seed=block_seeds.get(name))
            mode = self.block_remat[name] if torch.is_grad_enabled() else None
            if mode == "save_convs":
                return save_convs_checkpoint(block, h, emb, skip, **kw)
            if mode == "full":
                return checkpoint(block, h, emb, skip, use_reentrant=False, **kw)
            return block(h, emb, skip, **kw)

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
