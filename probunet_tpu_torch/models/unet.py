"""ADM U-Net backbone and the asymmetric post-U-Nets (port of
``probunet_tpu/models/unet.py``): :class:`UNet`, :class:`PostUNetWithSkips`,
:class:`PostUNetWithoutSkips` and the dispatcher :class:`UNetAll`.

The mapping network (``unet.py:131-169`` in the JAX package) builds the
embedding every block's FiLM affine reads:

- ``label_dim`` (default 1): ``map_label`` of the class labels, or of a
  zero dummy label when none are passed — the reference's current stack,
  where the embedding is exactly zero and each FiLM contributes only its
  learned bias. ``label_dim=0`` builds no ``map_label``.
  ``label_dropout``: in training, each sample's labels are zeroed with
  that probability, from a (B, 1) ``label_keep`` mask the caller passes
  or drawn from the caller's generator after the seed words.
- ``use_diffuse``: the noise labels (zeros when none are passed) through
  ``map_noise`` (:class:`PositionalEmbedding`, f32), ``map_layer0``, SiLU
  and ``map_layer1``, added to the embedding; a bf16 zero embedding plus
  this f32 one is f32, as in JAX.
- ``augment_dim``: ``map_augment`` of the augment labels, when passed.

Submodules carry the JAX package's names (``enc_128x128_conv``,
``dec_16x16_in0``, ``map_layer0``, ...) so the weight converter maps
parameter paths one to one. No block of the U-Net has attention, as in
the JAX module (its ``attn_resolutions`` is never read).

``train=True`` turns on each block's dropout (in kernel C, or kernel D on
the composed route; ``gn_impl`` picks the GroupNorm chains' route, see
``layers.EDMGroupNorm``). Every block takes its own (2,) int32 seed words:
the caller passes them as one (n_blocks, 2) tensor in block order
(``dropout_blocks``) or they are drawn from the caller's generator, as the
JAX U-Net draws one ``dropout`` key per block.

``act_compress``: every convolution keeps its input for the backward as
per-channel int8 (``layers.EDMConv``; the JAX package under
``PROBUNET_ACT_COMPRESS=int8``).

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

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from probunet_tpu_torch.models.layers import (
    INIT_DEFAULT,
    INIT_EDM,
    INIT_ZERO,
    EDMConv,
    EDMGroupNorm,
    EDMLinear,
    PositionalEmbedding,
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
                 *, generator: torch.Generator, label_dim: int = 1, augment_dim: int = 0,
                 model_channels: int = 16, channel_mult: Sequence[int] = (1, 4, 8, 16),
                 channel_mult_emb: int = 4, num_blocks: int = 2, dropout: float = 0.10,
                 label_dropout: float = 0.0, use_diffuse: bool = False,
                 dtype: torch.dtype | None = None, gn_impl: str = "kernel", remat=False,
                 act_compress: bool = False):
        super().__init__()
        mc = model_channels
        self.dtype = dtype
        self.dropout = dropout
        self.label_dim, self.label_dropout = label_dim, label_dropout
        self.use_diffuse, self.augment_dim = use_diffuse, augment_dim
        self.emb_channels = emb = mc * channel_mult_emb
        kw = dict(generator=generator, dtype=dtype)
        cv = dict(kw, act_compress=act_compress)
        self.dropout_blocks: list[str] = []  # every UNetBlock, in call order
        self.block_remat: dict[str, str | None] = {}

        def block(name, cin, cout, level, **extra):
            self.add_module(name, UNetBlock(cin, cout, emb, dropout=dropout, gn_impl=gn_impl,
                                            **cv, **extra))
            self.dropout_blocks.append(name)
            self.block_remat[name] = block_remat(remat, level)

        # the mapping network, in the JAX module's order
        if label_dim:
            self.map_label = EDMLinear(label_dim, emb, use_bias=False,
                                       init=("kaiming_normal", math.sqrt(label_dim), 0.0),
                                       generator=generator)
        if use_diffuse:
            self.map_noise = PositionalEmbedding(mc)
            self.map_layer0 = EDMLinear(mc, emb, init=INIT_EDM, generator=generator)
            self.map_layer1 = EDMLinear(emb, emb, init=INIT_EDM, generator=generator)
        if augment_dim:
            self.map_augment = EDMLinear(augment_dim, mc, use_bias=False, init=INIT_ZERO,
                                         generator=generator)
        # encoder: (name, pushes a skip); channels tracked as in the JAX module
        self.encoder: list[str] = []
        skip_ch = []
        cout = in_channels
        for level, mult in enumerate(channel_mult):
            rx, ry = img_resolution[0] >> level, img_resolution[1] >> level
            if level == 0:
                name = f"enc_{rx}x{ry}_conv"
                self.add_module(name, EDMConv(in_channels, mc * mult, 3, init=INIT_EDM, **cv))
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
        self.skip_channels = tuple(skip_ch[:3])   # of forward(return_skips=True)

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
        self.out_conv = EDMConv(cout, out_channels, 3, init=INIT_ZERO, **cv)

    def embedding(self, x: torch.Tensor, train: bool = False,
                  generator: torch.Generator | None = None,
                  noise_labels: torch.Tensor | None = None,
                  class_labels: torch.Tensor | None = None,
                  augment_labels: torch.Tensor | None = None,
                  label_keep: torch.Tensor | None = None) -> torch.Tensor:
        """The mapping network's (B, emb_channels) embedding before its
        SiLU, for the U-Net input ``x`` (in the compute dtype)."""
        b = x.shape[0]
        emb = torch.zeros((b, self.emb_channels), dtype=x.dtype, device=x.device)
        if self.label_dim:
            labels = (class_labels if class_labels is not None
                      else torch.zeros((b, self.label_dim), dtype=x.dtype, device=x.device))
            if train and self.label_dropout:
                if label_keep is None:
                    if generator is None:
                        raise ValueError("label dropout needs label_keep or a generator")
                    u = torch.rand((b, 1), generator=generator, device=generator.device)
                    label_keep = u >= self.label_dropout
                labels = labels * label_keep.to(device=labels.device, dtype=labels.dtype)
            emb = emb + self.map_label(labels)
        if self.use_diffuse:
            nl = (noise_labels if noise_labels is not None
                  else torch.zeros((b,), dtype=x.dtype, device=x.device))
            emb_n = F.silu(self.map_layer0(self.map_noise(nl)))
            emb = emb + self.map_layer1(emb_n)
        if self.augment_dim and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels)
        return emb

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None, return_skips: bool = False,
                noise_labels: torch.Tensor | None = None,
                class_labels: torch.Tensor | None = None,
                augment_labels: torch.Tensor | None = None,
                label_keep: torch.Tensor | None = None,
                slab: tuple[int, int] | None = None, rows=None, mesh=None):
        """``train``: dropout on. ``seeds``: (len(dropout_blocks), 2) int32
        seed words in block order; drawn from ``generator`` when None.
        ``slab``: (first row, global batch) of ``x`` in a data-parallel
        step, whose rows then get the global batch's dropout masks.
        ``rows`` (``parallel.spatial.Rows``): ``x`` is this rank's block of
        image rows; every block, convolution and GroupNorm chain takes it.
        ``mesh``: the training step's mesh, over whose ranks the compressed
        convolutions take their absmax (``act_compress``).
        ``return_skips``: also return the first three encoder outputs (NHWC
        views in the compute dtype), which the asymmetric U-Nets inject.
        ``noise_labels`` (B,), ``class_labels`` (B, label_dim),
        ``augment_labels`` (B, augment_dim): the mapping network's inputs.
        ``label_keep``: the (B, 1) label-dropout keep mask (bool), drawn
        from ``generator`` when None."""
        out_dtype = x.dtype
        if self.dtype is not None:
            x = x.to(self.dtype)
        block_seeds = {}
        if train and self.dropout > 0:
            if seeds is None:
                seeds = dropout_seeds(generator, len(self.dropout_blocks))
            if tuple(seeds.shape) != (len(self.dropout_blocks), 2):
                raise ValueError(f"seeds must be ({len(self.dropout_blocks)}, 2), got "
                                 f"{tuple(seeds.shape)}")
            block_seeds = dict(zip(self.dropout_blocks, seeds.to(x.device).unbind()))
        emb = F.silu(self.embedding(x, train, generator, noise_labels, class_labels,
                                    augment_labels, label_keep))

        def run(name, h, skip=None):
            block = self.get_submodule(name)
            kw = dict(train=train, drop_seed=block_seeds.get(name), slab=slab, rows=rows,
                      mesh=mesh)
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
            h = mod(h, rows=rows, mesh=mesh) if isinstance(mod, EDMConv) else run(name, h)
            skips.append(h)
        skips_postunet = [s.permute(0, 2, 3, 1) for s in skips[:3]]
        for name, takes_skip in self.decoder:
            h = run(name, h, skips.pop() if takes_skip else None)
        h = self.out_conv(self.out_norm(h, silu=True, rows=rows), rows=rows, mesh=mesh)
        out = h.permute(0, 2, 3, 1).to(out_dtype)
        return (out, skips_postunet) if return_skips else out


class _PostUNet(nn.Module):
    """The asymmetric U-Nets (``probunet_tpu/models/unet.py:238-347``): a
    core U-Net at the low-resolution grid with ``base_channels`` channels
    (not the config's ``model_channels``) and the core's default dropout of
    0.1, then log2(ds_scale) stages of a 2x up block and
    ``num_res_blocks + 1`` blocks halving the channels each stage (EDM
    default init, no dropout, the zero embedding: FiLM is bias-only).
    ``with_skips``: each stage block also takes an early encoder output
    (``skips[-(i + 1)]`` of the core's first three), nearest-upsampled,
    through a 3x3 conv and SiLU, as its ``skip_in``. NHWC in and out."""

    def __init__(self, img_resolution: Sequence[int], in_channels: int, ds_scale: int,
                 num_res_blocks: int, channel_mult: Sequence[int], out_channels: int, *,
                 generator: torch.Generator, with_skips: bool, base_channels: int = 64,
                 dtype: torch.dtype | None = None, gn_impl: str = "kernel",
                 act_compress: bool = False):
        super().__init__()
        base = base_channels
        emb = base * 4
        self.levels = int(math.log2(ds_scale))
        self.with_skips = with_skips
        self.num_res_blocks = num_res_blocks
        kw = dict(generator=generator, dtype=dtype, act_compress=act_compress)
        self.core_unet = UNet(tuple(img_resolution), in_channels, base, model_channels=base,
                              channel_mult=tuple(channel_mult), num_blocks=num_res_blocks,
                              gn_impl=gn_impl, **kw)
        self.emb_channels = emb
        c = base
        for lvl in range(1, self.levels + 1):
            self.add_module(f"post{lvl}_up", UNetBlock(c, c, emb, up=True, init=INIT_DEFAULT,
                                                       gn_impl=gn_impl, **kw))
            out = base // 2 ** lvl
            for i in range(num_res_blocks + 1):
                cin = c
                if with_skips:
                    skip_c = self.core_unet.skip_channels[-(i + 1)]
                    self.add_module(f"post{lvl}_skipconv{i}",
                                    EDMConv(skip_c, out, 3, init=INIT_DEFAULT, **kw))
                    cin += out
                self.add_module(f"post{lvl}_block{i}", UNetBlock(cin, out, emb,
                                                                 init=INIT_DEFAULT,
                                                                 gn_impl=gn_impl, **kw))
                c = out
        self.out_norm = EDMGroupNorm(c, gn_impl=gn_impl)
        self.out_conv = EDMConv(c, out_channels, 3, init=INIT_DEFAULT, **kw)

    @property
    def dropout_blocks(self) -> list[str]:
        return self.core_unet.dropout_blocks

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``seeds``/``generator``: the core U-Net's dropout seed words."""
        if self.with_skips:
            x, skips = self.core_unet(x, train, seeds, generator, return_skips=True)
            skips = [s.permute(0, 3, 1, 2) for s in skips]
        else:
            x = self.core_unet(x, train, seeds, generator)
        h = x.permute(0, 3, 1, 2)
        emb = torch.zeros((h.shape[0], self.emb_channels), dtype=h.dtype, device=h.device)
        for lvl in range(1, self.levels + 1):
            h = self.get_submodule(f"post{lvl}_up")(h, emb, train=train)
            for i in range(self.num_res_blocks + 1):
                skip_in = None
                if self.with_skips:
                    up = F.interpolate(skips[-(i + 1)], scale_factor=2 ** lvl, mode="nearest")
                    skip_in = F.silu(self.get_submodule(f"post{lvl}_skipconv{i}")(up))
                h = self.get_submodule(f"post{lvl}_block{i}")(h, emb, skip_in, train=train)
        h = self.out_conv(F.silu(self.out_norm(h)))
        return h.permute(0, 2, 3, 1)


class PostUNetWithSkips(_PostUNet):
    """Asymmetric U-Net with injected early-encoder skips
    (``probunet_tpu/models/unet.py:238``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, with_skips=True, **kwargs)


class PostUNetWithoutSkips(_PostUNet):
    """Asymmetric U-Net without extra skips (``probunet_tpu/models/unet.py:302``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, with_skips=False, **kwargs)


UNET_TYPES = ("symmetric", "asymmetric_wskips", "asymmetric_woskips")


class UNetAll(nn.Module):
    """The deterministic baselines' U-Net, one of three variants
    (``probunet_tpu/models/unet.py:350``), held as ``unet``:
    ``"symmetric"`` (:class:`UNet` at the full grid, ``model_channels``
    and ``dropout``), ``"asymmetric_wskips"`` / ``"asymmetric_woskips"``
    (the post-U-Nets at the grid divided by ``ds_scale``). NHWC in and
    out."""

    def __init__(self, type: str, img_resolution: Sequence[int], in_channels: int,
                 ds_scale: int, num_res_blocks: int, channel_mult: Sequence[int],
                 out_channels: int, model_channels: int = 16, dropout: float = 0.10,
                 dtype: torch.dtype | None = None, *, generator: torch.Generator,
                 gn_impl: str = "kernel", act_compress: bool = False):
        super().__init__()
        if type not in UNET_TYPES:
            raise ValueError(f'Invalid UNet type "{type}"')
        kw = dict(generator=generator, dtype=dtype, gn_impl=gn_impl, act_compress=act_compress)
        if type == "symmetric":
            self.unet = UNet(tuple(img_resolution), in_channels, out_channels,
                             model_channels=model_channels, channel_mult=tuple(channel_mult),
                             num_blocks=num_res_blocks, dropout=dropout, **kw)
        else:
            cls = PostUNetWithSkips if type == "asymmetric_wskips" else PostUNetWithoutSkips
            lr_res = (img_resolution[0] // ds_scale, img_resolution[1] // ds_scale)
            self.unet = cls(lr_res, in_channels, ds_scale, num_res_blocks,
                            tuple(channel_mult), out_channels, **kw)

    @property
    def dropout_blocks(self) -> list[str]:
        return self.unet.dropout_blocks

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.unet(x, train, seeds, generator)
