"""EDM-style primitive layers (port of ``probunet_tpu/models/layers.py``).

Inside the U-Net, activations are NCHW tensors in ``torch.channels_last``
memory format: an NHWC tensor ``x`` viewed as ``x.permute(0, 3, 1, 2)``
without a copy. The layers here take and return such NCHW views; the
public models (``UNet``, the Gaussians, ``Fcomb``, ``ProbabilisticUNet``)
take NHWC like the JAX package.

``dtype`` is the compute dtype (``None`` = the input's): conv operands
are cast to it and a bf16 conv returns a bf16-rounded result, as the JAX
convs with ``preferred_element_type=dt``; parameters stay f32, so a bias
add promotes to f32 and is rounded back to the activation dtype, the JAX
package's rounding points. The GroupNorm chain between the convs runs
through kernels C/C′ (``ops.kernels.fused_gn``, ``gn_impl="kernel"``) or
as a torch composition followed by kernel D (``ops.kernels.dropout``,
``gn_impl="composed"``); either way the dropout seed words come from the
caller and the masks are the JAX kernels'. ``UNetBlock(attention=True)``
adds the JAX block's self-attention (a plain GroupNorm chain, 1x1 qkv and
projection convs, an f32 softmax in plain torch); the JAX U-Net never
enables it, so no model path runs it. ``PositionalEmbedding`` and
``FourierEmbedding`` are the noise-level embeddings of the diffusion
U-Net (``UNet(use_diffuse=True)``).

``rows`` (``parallel.spatial.Rows``, the spatially sharded step): the
activations are this rank's block of image rows. A k x k convolution
then halo-exchanges k // 2 rows and convolves VALID over the rows and SAME
over the columns (kernel E, under int8, runs SAME on the halo-padded block
and the outer rows are cropped: its zero row padding falls only where the
halo is zeros too, at the image's edges); the GroupNorm chains take their
statistics over every rank's rows (kernels C/C′ split around the sum, or
the composed chain's partial sums summed) and the masks of the global
elements; the 2x resamplings stay local.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from probunet_tpu_torch.ops import quantize
from probunet_tpu_torch.ops.act_compress import act8_conv
from probunet_tpu_torch.ops.act_compress import conv as _conv
from probunet_tpu_torch.ops.kernels import fused_gn
from probunet_tpu_torch.ops.kernels.dropout import dropout as hash_dropout
from probunet_tpu_torch.ops.kernels.dropout import apply_keep, global_index, hash_uniform
from probunet_tpu_torch.ops.kernels.dropout import supported as dropout_supported
from probunet_tpu_torch.ops.precision import matmul_f32

# "kernel": kernels C/C′, the JAX package under PROBUNET_GN_IMPL=pallas;
# "composed": the torch composition + kernel D, the JAX default ("xla")
# under PROBUNET_DROPOUT_IMPL=pallas
GN_IMPLS = ("kernel", "composed")

# (init_mode, init_weight_scale, init_bias_scale), as in the JAX package
INIT_DEFAULT = ("kaiming_normal", 1.0, 0.0)
INIT_EDM = ("kaiming_uniform", math.sqrt(1.0 / 3.0), math.sqrt(1.0 / 3.0))
INIT_ZERO = ("kaiming_uniform", 0.0, 0.0)


def edm_init(mode: str, fan_in: int, fan_out: int, scale: float,
             shape: tuple[int, ...], generator: torch.Generator) -> torch.Tensor:
    """One EDM initializer draw (f32, on the generator's device), with the
    fan-in/fan-out given explicitly — the conv biases use the conv weight's
    fan-in, the EDM quirk."""
    if scale == 0.0:
        return torch.zeros(shape)
    dev = generator.device
    if mode == "xavier_uniform":
        w = math.sqrt(6 / (fan_in + fan_out)) * (
            torch.rand(shape, generator=generator, device=dev) * 2 - 1)
    elif mode == "xavier_normal":
        w = math.sqrt(2 / (fan_in + fan_out)) * torch.randn(
            shape, generator=generator, device=dev)
    elif mode == "kaiming_uniform":
        w = math.sqrt(3 / fan_in) * (
            torch.rand(shape, generator=generator, device=dev) * 2 - 1)
    elif mode == "kaiming_normal":
        w = math.sqrt(1 / fan_in) * torch.randn(shape, generator=generator, device=dev)
    else:
        raise ValueError(f'Invalid init mode "{mode}"')
    return w * scale


def _out_dtype(x: torch.Tensor, dtype: torch.dtype | None) -> torch.dtype:
    return dtype if dtype is not None else x.dtype


def save_convs_checkpoint(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under selective activation checkpointing that
    stores only the convolutions' outputs and recomputes every other
    operation in the backward (the GroupNorm chains, kernels C and D
    included, their masks regenerated from the same seed words): the JAX
    package's ``nn.remat`` with ``save_only_these_names("conv_out")``."""
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   [torch.ops.aten.convolution.default])
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)


def other_shape_dropout(y: torch.Tensor, seed2: torch.Tensor, p_drop: float,
                        offset: int = 0, item: int | None = None) -> torch.Tensor:
    """Inverted dropout of a tensor kernel D does not take (numel not a
    multiple of 1024, such as a 1x1 chain of 192 channels at batch 8),
    where the JAX module switches to ``jax.random.bernoulli``: plain torch
    operations on either device, the mask the same hash of the seed words
    at each element's row-major index in the global tensor (so a recompute
    regenerates it), kernel D's mapping ``dropout.global_index(offset,
    item)`` (a data-parallel slab's or a spatial block's elements). No TPU
    kernel computes this in the JAX package, and no launch counter counts
    it."""
    pos = global_index(y.shape, offset, item, y.device)
    keep = hash_uniform(pos, seed2.to(y.device),
                        torch.zeros((), dtype=torch.int64, device=y.device))
    return apply_keep(y, (keep >= np.float32(p_drop)).reshape(y.shape), p_drop)


class EDMLinear(nn.Module):
    """Fully-connected layer with EDM init; weight stored (out, in)."""

    def __init__(self, in_features: int, out_features: int, *, generator: torch.Generator,
                 use_bias: bool = True, init=INIT_DEFAULT,
                 dtype: torch.dtype | None = None):
        super().__init__()
        mode, w_scale, b_scale = init
        self.dtype = dtype
        self.weight = nn.Parameter(edm_init(mode, in_features, out_features, w_scale,
                                            (out_features, in_features), generator))
        self.bias = (nn.Parameter(edm_init(mode, in_features, out_features, b_scale,
                                           (out_features,), generator))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = matmul_f32(x, self.weight.T, _out_dtype(x, self.dtype))
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def halo_rows(x: torch.Tensor, halo: int, rows) -> torch.Tensor:
    """The NCHW (channels_last) view ``x`` of a block of rows with ``halo``
    rows of each neighbour block (zeros at the image's edges), exchanged
    over ``rows``'s axis on the NHWC view, so the result is channels_last
    too."""
    return rows.halo(x.permute(0, 2, 3, 1), halo).permute(0, 3, 1, 2)


class EDMConv(nn.Module):
    """k x k conv (k = 3 or 1) with optional fixed 2x resampling before it:
    nearest 2x upsampling (``up``) or 2x2 mean pooling (``down``).
    ``kernel=0`` resamples only (the channel-preserving skip path).

    int8 serving (``ops.quantize``): a convolution records the absmax of its
    input after the resampling (and of ``x2``) under ``record_absmax``, and
    runs kernel E when ``quant_scales`` holds every scale its call needs,
    else its float path.

    ``act_compress`` (the JAX package's ``PROBUNET_ACT_COMPRESS=int8``): the
    float path's convolutions keep their inputs for the backward as
    per-channel int8 (``ops.act_compress.act8_conv``; each input of the
    split form on its own, the halo-padded block under a spatial mesh). The
    int8 serving route takes precedence."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, *,
                 generator: torch.Generator, up: bool = False, down: bool = False,
                 init=INIT_DEFAULT, dtype: torch.dtype | None = None,
                 act_compress: bool = False):
        super().__init__()
        if up and down:
            raise ValueError("EDMConv: up and down are exclusive")
        self.up, self.down, self.kernel, self.dtype = up, down, kernel, dtype
        self.act_compress = act_compress
        self.weight = self.bias = None
        self.quant_scales = None
        if kernel:
            mode, w_scale, b_scale = init
            fan_in = in_channels * kernel * kernel
            fan_out = out_channels * kernel * kernel
            self.weight = nn.Parameter(edm_init(
                mode, fan_in, fan_out, w_scale,
                (out_channels, in_channels, kernel, kernel), generator))
            self.bias = nn.Parameter(edm_init(mode, fan_in, fan_out, b_scale,
                                              (out_channels,), generator))

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None,
                rows=None, mesh=None) -> torch.Tensor:
        """``x2``: an optional second input, channel-concatenated after ``x``
        without materializing the concat: conv([x; x2], W) =
        conv(x, W[:, :c1]) + conv(x2, W[:, c1:]), each rounded like the JAX
        split form. ``rows``: x (and x2) is this rank's block of rows; each
        input is halo-exchanged. ``mesh``: the training step's mesh, over
        whose ("data", "spatial") ranks ``act_compress`` takes each input's
        absmax."""
        if x2 is not None and (not self.kernel or self.up or self.down):
            raise ValueError("EDMConv: x2 needs a kernel and no resampling")
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            x = F.avg_pool2d(x, 2)
        if not self.kernel:
            return x
        quantize.observe(self, x)
        if x2 is not None:
            quantize.observe(self, x2, "absmax2")
        halo = self.kernel // 2 if rows is not None else 0
        h = x.shape[2]
        if halo:
            x = halo_rows(x, halo, rows)
            x2 = None if x2 is None else halo_rows(x2, halo, rows)
        if quantize.takes_int8(self, x2 is not None):
            y = quantize.int8_forward(self, x, x2)
            if halo:   # E pads SAME: the halo rows' outputs are cropped
                y = y[:, :, halo:halo + h].contiguous(memory_format=torch.channels_last)
            return y
        dt = _out_dtype(x, self.dtype)

        def conv(inp, w):
            if self.act_compress:
                return act8_conv(inp, w, dt, bool(halo), mesh)
            return _conv(inp, w, dt, bool(halo))

        if x2 is None:
            y = conv(x, self.weight)
        else:
            c1 = x.shape[1]
            y = conv(x, self.weight[:, :c1]) + conv(x2, self.weight[:, c1:])
        return (y + self.bias[:, None, None]).to(x.dtype)


class EDMGroupNorm(nn.Module):
    """GroupNorm with groups = min(32, C // 4), ``eps`` 1e-5, evaluated with the
    UNetBlock chain that follows it:

        dropout(silu((gn(x) * gamma + beta) * (scale + 1) + shift))

    (``layers.py:345-378`` in the JAX package), by one of two routes:

    - ``gn_impl="kernel"`` (the default): kernels C and C′
      (``ops.kernels.fused_gn``) on the NHWC view of the channels_last
      activation, output in x's dtype, with the TPU kernel's arithmetic
      (statistics s1, s2 in f32, no clamp of the variance) and its dropout
      masks. The JAX package with ``PROBUNET_GN_IMPL=pallas``.
    - ``gn_impl="composed"``: a plain torch composition like the JAX
      default (XLA's GN fusion): f32 statistics with the fast variance
      E[x^2] - E[x]^2 (clipped at 0, as flax computes it), normalization in
      f32, output in ``dtype``, and with ``drop_p > 0`` kernel D's dropout
      on the NHWC view (:func:`other_shape_dropout` for a shape D does not
      take). The JAX default with ``PROBUNET_DROPOUT_IMPL=pallas``.

    A shape the kernel does not take (``fused_gn.supported``) runs the
    composed route on either setting, as the JAX module decides; the
    choice is made from the shape, before any launch. Dropout takes the
    (2,) int32 ``drop_seed``. ``slab`` = (first row, global batch) places
    x in the global batch of a data-parallel step: the masks are those of
    the global batch's rows (C's seed words from ``fused_gn.slab_seed``,
    D's element offset and block height), and D or the other-shape hash is
    chosen from the global shape. ``rows``: x is this rank's block of
    image rows (``parallel.spatial.Rows``): the statistics are summed over
    the ranks (kernels C/C′ split around the sum of their partials; the
    composed chain's partial sums summed, divided by the global count), the
    masks are those of the global elements (C's seed words shifted by the
    block's first element, D's mapping), and the routes are chosen from the
    global shape, so a block takes the route the whole image takes.
    """

    def __init__(self, num_channels: int, *, dtype: torch.dtype | None = None,
                 gn_impl: str = "kernel", eps: float = 1e-5):
        super().__init__()
        if gn_impl not in GN_IMPLS:
            raise ValueError(f"gn_impl must be one of {GN_IMPLS}, got {gn_impl!r}")
        self.groups = min(32, num_channels // 4)
        self.eps = eps
        self.dtype = dtype
        self.gn_impl = gn_impl
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, silu: bool = False,
                film: tuple[torch.Tensor, torch.Tensor] | None = None,
                drop_p: float = 0.0, drop_seed: torch.Tensor | None = None,
                slab: tuple[int, int] | None = None, rows=None) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.groups
        if drop_p > 0.0 and drop_seed is None:
            raise ValueError("EDMGroupNorm: drop_p > 0 needs drop_seed")
        b0, b_total = (0, b) if slab is None else slab
        h0, h_total = (0, h) if rows is None else (rows.first(h), rows.whole(h))
        if self.gn_impl == "kernel" and fused_gn.supported(h_total, w, c, g):
            return self._kernel_chain(x, silu, film, drop_p, drop_seed, b0, h0 * w * c, rows)
        xf = x.float().unflatten(1, (g, c // g))              # (B, G, C/G, H, W)
        if rows is None:
            mean = xf.mean(dim=(2, 3, 4), keepdim=True)
            mean2 = (xf * xf).mean(dim=(2, 3, 4), keepdim=True)
        else:   # the block's sums, summed over the ranks in one all-reduce
            sums = rows.sum(torch.stack([xf.sum(dim=(2, 3, 4)), (xf * xf).sum(dim=(2, 3, 4))]))
            mean, mean2 = (sums / (h_total * w * (c // g)))[..., None, None, None].unbind()
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        gamma = self.weight.reshape(1, g, c // g, 1, 1)
        beta = self.bias.reshape(1, g, c // g, 1, 1)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * gamma) + beta
        out_dt = self.dtype if self.dtype is not None else torch.promote_types(
            x.dtype, torch.float32)
        y = y.flatten(1, 2).to(out_dt)
        if film is not None:
            scale, shift = film
            y = shift[:, :, None, None] + y * (scale[:, :, None, None] + 1)
        y = F.silu(y) if silu else y
        if drop_p > 0.0:
            # the masks follow the row-major NHWC index: contiguous() copies
            # only a tensor that is not channels_last (a 1x1 map upsampled
            # on the card comes back NCHW-contiguous)
            yn = y.permute(0, 2, 3, 1).contiguous()
            item = h_total * w * c
            whole = dropout_supported((b_total, h_total, w, c))
            if slab is None and rows is None:
                yn = (hash_dropout(yn, drop_seed, drop_p) if whole
                      else other_shape_dropout(yn, drop_seed, drop_p))
            else:   # a block of the global tensor: item b at b0 + b, its rows from h0
                at = b0 * item + h0 * w * c
                yn = (hash_dropout(yn, drop_seed, drop_p, at, b_total * item, item) if whole
                      else other_shape_dropout(yn, drop_seed, drop_p, at, item))
            y = yn.permute(0, 3, 1, 2)
        return y

    def _kernel_chain(self, x, silu, film, drop_p, drop_seed, batch_offset=0, row_offset=0,
                      rows=None):
        b, c = x.shape[:2]
        # NHWC view; contiguous() copies only an input that is not channels_last
        # (none on the U-Net's path: chip_smoke.py counts them)
        xn = x.permute(0, 2, 3, 1).contiguous()
        if film is None:  # norm0 and out_norm: scale = shift = 0
            scale = shift = torch.zeros((b, c), dtype=torch.float32, device=x.device)
        else:
            scale, shift = (t.float().contiguous() for t in film)
        if drop_p <= 0.0:
            drop_seed = torch.zeros(2, dtype=torch.int32, device=x.device)
        else:
            drop_seed = fused_gn.slab_seed(drop_seed, batch_offset, row_offset)
        y = fused_gn.gn_film_silu_dropout(xn, self.weight, self.bias, scale, shift, drop_seed,
                                          self.groups, self.eps, drop_p, silu, rows)
        return y.permute(0, 3, 1, 2)


class PositionalEmbedding(nn.Module):
    """The DDPM++/ADM noise-level embedding (``layers.py:381`` in the JAX
    package): (N,) -> (N, num_channels) f32, the cosines of x times the
    frequencies (1 / max_positions) ** (i / (half - endpoint)) and then
    their sines. No parameters."""

    def __init__(self, num_channels: int, max_positions: int = 10000,
                 endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = (
            num_channels, max_positions, endpoint)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = (1.0 / self.max_positions) ** freqs
        args = torch.outer(x.float(), freqs)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class FourierEmbedding(nn.Module):
    """The NCSN++ Fourier embedding (``layers.py:397`` in the JAX package):
    (N,) -> (N, num_channels) f32, cosines then sines of x * 2 pi * freqs,
    with ``freqs`` a parameter of num_channels // 2 standard normal draws
    times ``scale``."""

    def __init__(self, num_channels: int, scale: float = 16.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.freqs = nn.Parameter(torch.randn(num_channels // 2, generator=generator,
                                              device=generator.device) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        args = torch.outer(x.float(), 2 * math.pi * self.freqs)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=1)


class UNetBlock(nn.Module):
    """Residual U-Net block (``layers.py:414`` in the JAX package; ``init``
    for its convs and FiLM layer, EDM by default as the U-Net builds it,
    ``init_zero`` for the second conv and the attention projection):

        GN -> SiLU -> conv(up/down) -> FiLM from the embedding -> SiLU ->
        dropout (``train`` only) -> conv -> (+ skip) * skip_scale

    ``adaptive_scale=False`` adds the embedding's projection to the conv
    output before the second GroupNorm instead of the FiLM (scale, shift).
    ``attention`` then adds self-attention over the pixels: ``num_heads``
    heads (or out_channels // ``channels_per_head``), a plain GroupNorm
    chain (no SiLU, no FiLM), 1x1 qkv conv (``init_attn``, else ``init``),
    the logits q.k / sqrt(ch) and their softmax in f32, the weights cast
    to x's type, a 1x1 projection added to x and scaled by ``skip_scale``.
    It runs in plain torch: the JAX package computes it outside any TPU
    kernel. ``in_channels`` counts the skip tensor that the decoder's
    blocks take as ``skip_in``. ``gn_impl``: the route of the GroupNorm
    chains (:class:`EDMGroupNorm`); ``act_compress``: the convolutions'
    (:class:`EDMConv`)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 generator: torch.Generator, up: bool = False, down: bool = False,
                 attention: bool = False, num_heads: int | None = None,
                 channels_per_head: int = 64, dropout: float = 0.0,
                 skip_scale: float = 1.0, eps: float = 1e-5, adaptive_scale: bool = True,
                 dtype: torch.dtype | None = None, gn_impl: str = "kernel",
                 act_compress: bool = False,
                 init=INIT_EDM, init_zero=INIT_ZERO, init_attn=None):
        super().__init__()
        self.dropout = dropout
        self.skip_scale = skip_scale
        self.adaptive_scale = adaptive_scale
        self.num_heads = 0 if not attention else (
            num_heads if num_heads is not None else out_channels // channels_per_head)
        kw = dict(generator=generator, dtype=dtype)
        cv = dict(kw, act_compress=act_compress)
        gn = dict(dtype=dtype, gn_impl=gn_impl, eps=eps)
        self.norm0 = EDMGroupNorm(in_channels, **gn)
        self.conv0 = EDMConv(in_channels, out_channels, 3, up=up, down=down,
                             init=init, **cv)
        self.affine = EDMLinear(emb_channels, out_channels * (2 if adaptive_scale else 1),
                                init=init, **kw)
        self.norm1 = EDMGroupNorm(out_channels, **gn)
        self.conv1 = EDMConv(out_channels, out_channels, 3, init=init_zero, **cv)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if out_channels != in_channels else 0
            self.skip = EDMConv(in_channels, out_channels, kernel, up=up, down=down,
                                init=init, **cv)
        if self.num_heads:
            self.norm2 = EDMGroupNorm(out_channels, **gn)
            self.qkv = EDMConv(out_channels, out_channels * 3, 1,
                               init=init_attn if init_attn is not None else init, **cv)
            self.proj = EDMConv(out_channels, out_channels, 1, init=init_zero, **cv)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                skip_in: torch.Tensor | None = None, train: bool = False,
                drop_seed: torch.Tensor | None = None,
                slab: tuple[int, int] | None = None, rows=None, mesh=None) -> torch.Tensor:
        """``drop_seed``: this block's (2,) int32 dropout seed words, needed
        when ``train`` and ``dropout > 0``. ``slab``: (first row, global
        batch) of x in a data-parallel step (``EDMGroupNorm``). ``rows``: x
        is this rank's block of image rows (``parallel.spatial.Rows``).
        ``mesh``: the training step's mesh (:class:`EDMConv`)."""
        if self.num_heads and rows is not None:
            from probunet_tpu_torch.parallel.spatial import deferred

            raise deferred("UNetBlock's self-attention")
        x_in = x
        full = x if skip_in is None else torch.cat([x, skip_in.to(x.dtype)], dim=1)
        h = self.conv0(self.norm0(full, silu=True, rows=rows), rows=rows, mesh=mesh)
        params = self.affine(emb)
        drop_p = self.dropout if train else 0.0
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=-1)
            h = self.norm1(h, silu=True, film=(scale, shift), drop_p=drop_p,
                           drop_seed=drop_seed, slab=slab, rows=rows)
        else:
            h = self.norm1(h + params[:, :, None, None], silu=True, drop_p=drop_p,
                           drop_seed=drop_seed, slab=slab, rows=rows)
        h = self.conv1(h, rows=rows, mesh=mesh)
        if self.skip is None:
            skip = full
        elif skip_in is not None:
            skip = self.skip(x_in, skip_in.to(x_in.dtype), rows=rows, mesh=mesh)
        else:
            skip = self.skip(full, rows=rows, mesh=mesh)
        x = h + skip
        if self.skip_scale != 1.0:
            x = x * self.skip_scale
        if self.num_heads:
            x = self._attention(x, mesh)
        return x

    def _attention(self, x: torch.Tensor, mesh=None) -> torch.Tensor:
        """The attention branch on the NCHW (channels_last) view ``x``."""
        b, c, h, w = x.shape
        heads = self.num_heads
        ch = c // heads
        qkv = self.qkv(self.norm2(x), mesh=mesh).permute(0, 2, 3, 1)  # (B, H, W, 3C)
        # (B, HW, heads, 3ch) -> (B * heads, 3, ch, HW), the JAX split
        qkv = qkv.reshape(b, h * w, heads, 3 * ch).permute(0, 2, 3, 1)
        qkv = qkv.reshape(b * heads, 3, ch, h * w)
        q, k, v = qkv.unbind(1)                                       # (B * heads, ch, HW)
        logits = torch.einsum("ncq,nck->nqk", q.float(), k.float() / math.sqrt(ch))
        wgt = torch.softmax(logits, dim=2).to(x.dtype)
        a = torch.einsum("nqk,nck->ncq", wgt, v)
        a = a.reshape(b, heads, ch, h * w).permute(0, 3, 1, 2).reshape(b, h, w, c)
        return (x + self.proj(a.permute(0, 3, 1, 2), mesh=mesh)) * self.skip_scale
