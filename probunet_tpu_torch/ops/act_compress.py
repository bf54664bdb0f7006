"""int8 storage of the convolutions' saved inputs (port of
``probunet_tpu/ops/act_compress.py``).

A convolution whose backward keeps its input x only as per-channel int8:

    forward:   y = conv(x, w)                        exact: the float convolution
    saved:     q = rint(x / s) int8, s (C,), w       x itself is not kept
    backward:  dx = conv_backward_input(g, w)        exact: it never reads x
               dW = conv_backward_weight(xh, g)      xh = f32(q) * s in x's type,
                                                     the only approximation

with ``absmax[c] = max |f32(x)|`` over every other axis, ``s = max(absmax,
1e-12) / 127`` and an IEEE division rounded half to even, the JAX
package's ``_quantize_channels`` at each rounding point. The loss and every
activation are those of the float step; only the weight gradients see the
int8 error (at most s / 2 an element).

The switch is the ``EDMConv`` argument ``act_compress`` (threaded from
``ProbabilisticUNet``, ``UNet``, ``UNetAll`` and ``EDMPrecond`` as
``gn_impl`` is). The entry points that build a model for training (``cli.py
train`` and ``train-det``, ``bench.py``, through ``cli.make_model`` and
``make_det_model``) read the JAX package's environment variable
``PROBUNET_ACT_COMPRESS=int8`` (:func:`enabled`). Off by default.

``x`` is the NCHW view of a channels_last activation, so its NHWC view is a
row-major (rows, C) matrix. Kernels (``csrc/act_compress.cu``):

- F, :func:`quantize_channels`: two launches, the per-channel absmax and
  then s and q. On a mesh the absmax is taken over every rank's rows
  between them (one MAX all-reduce over ("data", "spatial")), as the JAX
  step, one program over the global batch, takes it;
- F′, :func:`dequantize`: xh for the weight gradient. The convolutions of
  the backward are PyTorch's (``aten.convolution_backward``), as the JAX
  package leaves them to XLA.

CPU tensors take the plain versions beside them; a CUDA tensor launches
the kernel or raises. Each wrapper counts its launches in ``launches``
(F once a quantization, for its two launches).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from probunet_tpu_torch.ops.kernels import _build
from probunet_tpu_torch.ops.kernels.int8_conv import over_qmax

SOURCE = "probunet_tpu_torch/csrc/act_compress.cu"
REPLACES = "probunet_tpu/ops/act_compress.py:66"       # _quantize_channels
REPLACES_DEQUANTIZE = "probunet_tpu/ops/act_compress.py:95"

_DTYPES = (torch.float32, torch.bfloat16)


def enabled(env=os.environ) -> bool:
    """The JAX package's switch: ``PROBUNET_ACT_COMPRESS=int8``."""
    return env.get("PROBUNET_ACT_COMPRESS", "") == "int8"


def conv(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype, padded: bool = False
         ) -> torch.Tensor:
    """The float convolution of ``layers.EDMConv``: SAME; ``padded``: x's
    rows carry their halo already (VALID over the rows, SAME over the
    columns). Operands cast to ``dt``."""
    return F.conv2d(x.to(dt), w.to(dt), padding=_padding(w, padded))


def _padding(w: torch.Tensor, padded: bool) -> tuple[int, int]:
    k = w.shape[-1] // 2
    return (0, k) if padded else (k, k)


# ---------------------------------------------------------------------------
# F and F′: plain versions
# ---------------------------------------------------------------------------

def absmax_plain(xn: torch.Tensor) -> torch.Tensor:
    """(C,) f32 max |x| over every axis but the last (|x| and the max are
    exact in x's type; a NaN propagates)."""
    return xn.abs().amax(dim=tuple(range(xn.dim() - 1))).float()


def scales_plain(absmax: torch.Tensor) -> torch.Tensor:
    """s = max(absmax, 1e-12) / 127 in f32 (an IEEE division on either
    device)."""
    return over_qmax(torch.clamp(absmax, min=1e-12))


def quantize_plain(xn: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """rint(f32(x) / s) as int8, ties to even."""
    return torch.round(xn.float() / s).to(torch.int8)


def dequantize_plain(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32(q) * s, rounded once to ``dtype``."""
    return (q.float() * s).to(dtype)


# ---------------------------------------------------------------------------
# F and F′: wrappers
# ---------------------------------------------------------------------------

def _rows(xn: torch.Tensor) -> tuple[int, int]:
    c = xn.shape[-1]
    return xn.numel() // c, c


def _check(t: torch.Tensor, what: str, dtypes=_DTYPES) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"act_compress: {what} on {t.device}; the kernel needs a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"act_compress: {what} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"act_compress: {what} (shape {tuple(t.shape)}, strides "
                         f"{t.stride()}) is not row-major contiguous: pass the NHWC view "
                         "of a channels_last activation")


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """1 where the kernels take 8 elements a thread (C % 8 == 0 and every
    pointer 16-byte aligned), else 0."""
    return int(c % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_absmax(xn: torch.Tensor) -> torch.Tensor:
    _check(xn, "x")
    rows, c = _rows(xn)
    out = torch.empty(c, dtype=torch.float32, device=xn.device)
    with torch.cuda.device(xn.device):
        err = _build.library().act8_absmax(xn.data_ptr(), out.data_ptr(), rows, c,
                                           int(xn.dtype == torch.bfloat16), _vec(c, xn),
                                           _stream(xn))
    _build.check(err, "act8_absmax")
    return out


def _launch_quantize(xn: torch.Tensor, absmax: torch.Tensor):
    _check(xn, "x")
    rows, c = _rows(xn)
    if absmax.dtype != torch.float32 or tuple(absmax.shape) != (c,) \
            or absmax.device != xn.device or not absmax.is_contiguous():
        raise ValueError(f"act_compress: absmax must be a contiguous f32 ({c},) tensor on "
                         f"{xn.device}")
    q = torch.empty(xn.shape, dtype=torch.int8, device=xn.device)
    s = torch.empty(c, dtype=torch.float32, device=xn.device)
    with torch.cuda.device(xn.device):
        err = _build.library().act8_quantize(xn.data_ptr(), absmax.data_ptr(), q.data_ptr(),
                                             s.data_ptr(), rows, c,
                                             int(xn.dtype == torch.bfloat16), _vec(c, xn, q),
                                             _stream(xn))
    _build.check(err, "act8_quantize")
    quantize_channels.launches += 1
    return q, s


def _launch_dequantize(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    _check(q, "q", (torch.int8,))
    rows, c = _rows(q)
    if s.dtype != torch.float32 or tuple(s.shape) != (c,) or s.device != q.device \
            or not s.is_contiguous():
        raise ValueError(f"act_compress: s must be a contiguous f32 ({c},) tensor on "
                         f"{q.device}")
    if dtype not in _DTYPES:
        raise ValueError(f"act_compress: xh must be one of {_DTYPES}, got {dtype}")
    xh = torch.empty(q.shape, dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library().act8_dequantize(q.data_ptr(), s.data_ptr(), xh.data_ptr(), rows,
                                               c, int(dtype == torch.bfloat16),
                                               _vec(c, q, xh), _stream(q))
    _build.check(err, "act8_dequantize")
    dequantize.launches += 1
    return xh


def quantize_channels(xn: torch.Tensor, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, s) of the channels-last ``xn`` (channels on the last axis):
    q int8 of xn's shape, s (C,) f32. ``mesh`` (``parallel.mesh.Mesh``):
    xn is this rank's part of the step's global batch, and the absmax is
    the global one (a MAX all-reduce over ("data", "spatial") between the
    two launches). CPU tensors take the plain versions; CUDA tensors launch
    kernel F (f32 or bf16, row-major contiguous) or raise."""
    cpu = xn.device.type == "cpu"
    absmax = absmax_plain(xn) if cpu else _launch_absmax(xn)
    if mesh is not None:
        from probunet_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, all_reduce_

        all_reduce_(absmax, mesh, (DATA_AXIS, SPATIAL_AXIS), op="max")
    if cpu:
        s = scales_plain(absmax)
        return quantize_plain(xn, s), s
    return _launch_quantize(xn, absmax)


def dequantize(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """xh = f32(q) * s in ``dtype``, q's shape. CPU tensors take
    :func:`dequantize_plain`; CUDA tensors launch kernel F′ or raise."""
    if q.device.type == "cpu":
        return dequantize_plain(q, s, dtype)
    return _launch_dequantize(q, s, dtype)


quantize_channels.launches = 0
dequantize.launches = 0


# ---------------------------------------------------------------------------
# The convolution
# ---------------------------------------------------------------------------

class _Act8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dt, padded, mesh):
        y = conv(x, w, dt, padded)
        # the NHWC view of the channels_last x; contiguous() copies only an
        # input in another memory order
        q, s = quantize_channels(x.permute(0, 2, 3, 1).contiguous(), mesh)
        ctx.save_for_backward(q, s, w)
        ctx.consts = (x.dtype, dt, padded)
        return y

    @staticmethod
    def backward(ctx, g):
        q, s, w = ctx.saved_tensors
        x_dtype, dt, padded = ctx.consts
        need_x, need_w = ctx.needs_input_grad[:2]
        xh = dequantize(q, s, x_dtype).permute(0, 3, 1, 2)   # NCHW, channels_last
        # the float convolution's own backward at xh, as autograd calls it
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, xh.to(dt), w.to(dt), None, [1, 1], list(_padding(w, padded)), [1, 1], False,
            [0, 0], 1, [need_x, need_w, False])
        return (dx.to(x_dtype) if need_x else None, dw.to(w.dtype) if need_w else None,
                None, None, None)


def act8_conv(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype, padded: bool = False,
              mesh=None) -> torch.Tensor:
    """:func:`conv` whose backward keeps x only as per-channel int8 (module
    docstring). ``mesh``: the step's mesh, over whose ("data", "spatial")
    ranks the absmax is taken. With grad mode off, or neither x nor w
    requiring a gradient, it is :func:`conv` and launches nothing, as the
    JAX ``custom_vjp`` runs its primal when not differentiated."""
    if not torch.is_grad_enabled() or not (x.requires_grad or w.requires_grad):
        return conv(x, w, dt, padded)
    return _Act8Conv.apply(x, w, dt, bool(padded), mesh)
