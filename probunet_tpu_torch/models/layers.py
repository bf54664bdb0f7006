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
caller and the masks are the JAX kernels'. The attention block is not
ported: neither the serve nor the training path runs it.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from probunet_tpu_torch.ops.kernels import fused_gn
from probunet_tpu_torch.ops.kernels.dropout import dropout as hash_dropout
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


def _conv(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dt), w.to(dt), padding=w.shape[-1] // 2)


class EDMConv(nn.Module):
    """k x k conv (k = 3 or 1) with optional fixed 2x resampling before it:
    nearest 2x upsampling (``up``) or 2x2 mean pooling (``down``).
    ``kernel=0`` resamples only (the channel-preserving skip path)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, *,
                 generator: torch.Generator, up: bool = False, down: bool = False,
                 init=INIT_DEFAULT, dtype: torch.dtype | None = None):
        super().__init__()
        if up and down:
            raise ValueError("EDMConv: up and down are exclusive")
        self.up, self.down, self.kernel, self.dtype = up, down, kernel, dtype
        self.weight = self.bias = None
        if kernel:
            mode, w_scale, b_scale = init
            fan_in = in_channels * kernel * kernel
            fan_out = out_channels * kernel * kernel
            self.weight = nn.Parameter(edm_init(
                mode, fan_in, fan_out, w_scale,
                (out_channels, in_channels, kernel, kernel), generator))
            self.bias = nn.Parameter(edm_init(mode, fan_in, fan_out, b_scale,
                                              (out_channels,), generator))

    def forward(self, x: torch.Tensor, x2: torch.Tensor | None = None) -> torch.Tensor:
        """``x2``: an optional second input, channel-concatenated after ``x``
        without materializing the concat: conv([x; x2], W) =
        conv(x, W[:, :c1]) + conv(x2, W[:, c1:]), each rounded like the JAX
        split form."""
        if x2 is not None and (not self.kernel or self.up or self.down):
            raise ValueError("EDMConv: x2 needs a kernel and no resampling")
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.down:
            x = F.avg_pool2d(x, 2)
        if not self.kernel:
            return x
        dt = _out_dtype(x, self.dtype)
        if x2 is None:
            y = _conv(x, self.weight, dt)
        else:
            c1 = x.shape[1]
            y = _conv(x, self.weight[:, :c1], dt) + _conv(x2, self.weight[:, c1:], dt)
        return (y + self.bias[:, None, None]).to(x.dtype)


class EDMGroupNorm(nn.Module):
    """GroupNorm with groups = min(32, C // 4), eps 1e-5, evaluated with the
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
      on the NHWC view. The JAX default with
      ``PROBUNET_DROPOUT_IMPL=pallas``.

    A shape the kernel does not take (``fused_gn.supported``) runs the
    composed route on either setting, as the JAX module decides; the
    choice is made from the shape, before any launch. Dropout takes the
    (2,) int32 ``drop_seed``.
    """

    def __init__(self, num_channels: int, *, dtype: torch.dtype | None = None,
                 gn_impl: str = "kernel"):
        super().__init__()
        if gn_impl not in GN_IMPLS:
            raise ValueError(f"gn_impl must be one of {GN_IMPLS}, got {gn_impl!r}")
        self.groups = min(32, num_channels // 4)
        self.dtype = dtype
        self.gn_impl = gn_impl
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, silu: bool = False,
                film: tuple[torch.Tensor, torch.Tensor] | None = None,
                drop_p: float = 0.0, drop_seed: torch.Tensor | None = None) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.groups
        if drop_p > 0.0 and drop_seed is None:
            raise ValueError("EDMGroupNorm: drop_p > 0 needs drop_seed")
        if self.gn_impl == "kernel" and fused_gn.supported(h, w, c, g):
            return self._kernel_chain(x, silu, film, drop_p, drop_seed)
        xf = x.float().unflatten(1, (g, c // g))              # (B, G, C/G, H, W)
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        mean2 = (xf * xf).mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        gamma = self.weight.reshape(1, g, c // g, 1, 1)
        beta = self.bias.reshape(1, g, c // g, 1, 1)
        y = (xf - mean) * (torch.rsqrt(var + 1e-5) * gamma) + beta
        out_dt = self.dtype if self.dtype is not None else torch.promote_types(
            x.dtype, torch.float32)
        y = y.flatten(1, 2).to(out_dt)
        if film is not None:
            scale, shift = film
            y = shift[:, :, None, None] + y * (scale[:, :, None, None] + 1)
        y = F.silu(y) if silu else y
        if drop_p > 0.0:
            y = hash_dropout(y.permute(0, 2, 3, 1), drop_seed, drop_p).permute(0, 3, 1, 2)
        return y

    def _kernel_chain(self, x, silu, film, drop_p, drop_seed):
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
        y = fused_gn.gn_film_silu_dropout(xn, self.weight, self.bias, scale, shift, drop_seed,
                                          self.groups, 1e-5, drop_p, silu)
        return y.permute(0, 3, 1, 2)


class UNetBlock(nn.Module):
    """Residual U-Net block as the U-Net builds it (EDM init, zero-init
    second conv, skip scale 1, no attention):
    GN -> SiLU -> conv(up/down) -> FiLM from the embedding -> SiLU ->
    dropout (``train`` only) -> conv -> + skip. ``in_channels`` counts the
    skip tensor that the decoder's blocks take as ``skip_in``. ``gn_impl``:
    the route of both GroupNorm chains (:class:`EDMGroupNorm`)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, *,
                 generator: torch.Generator, up: bool = False, down: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype | None = None,
                 gn_impl: str = "kernel"):
        super().__init__()
        self.dropout = dropout
        kw = dict(generator=generator, dtype=dtype)
        self.norm0 = EDMGroupNorm(in_channels, dtype=dtype, gn_impl=gn_impl)
        self.conv0 = EDMConv(in_channels, out_channels, 3, up=up, down=down,
                             init=INIT_EDM, **kw)
        self.affine = EDMLinear(emb_channels, out_channels * 2, init=INIT_EDM, **kw)
        self.norm1 = EDMGroupNorm(out_channels, dtype=dtype, gn_impl=gn_impl)
        self.conv1 = EDMConv(out_channels, out_channels, 3, init=INIT_ZERO, **kw)
        self.skip = None
        if out_channels != in_channels or up or down:
            kernel = 1 if out_channels != in_channels else 0
            self.skip = EDMConv(in_channels, out_channels, kernel, up=up, down=down,
                                init=INIT_EDM, **kw)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                skip_in: torch.Tensor | None = None, train: bool = False,
                drop_seed: torch.Tensor | None = None) -> torch.Tensor:
        """``drop_seed``: this block's (2,) int32 dropout seed words, needed
        when ``train`` and ``dropout > 0``."""
        x_in = x
        full = x if skip_in is None else torch.cat([x, skip_in.to(x.dtype)], dim=1)
        h = self.conv0(self.norm0(full, silu=True))
        scale, shift = self.affine(emb).chunk(2, dim=-1)
        drop_p = self.dropout if train else 0.0
        h = self.conv1(self.norm1(h, silu=True, film=(scale, shift), drop_p=drop_p,
                                  drop_seed=drop_seed))
        if self.skip is None:
            skip = full
        elif skip_in is not None:
            skip = self.skip(x_in, skip_in.to(x_in.dtype))
        else:
            skip = self.skip(full)
        return h + skip
