"""The int8 serving path's convolution: CUDA kernel E (``csrc/int8_conv.cu``)
and plain version.

No TPU kernel: the JAX package computes this convolution with XLA
(``probunet_tpu/ops/quantize.py:63-80``, ``lax.conv_general_dilated`` of
int8 operands into int32). For a k x k convolution (k = 1 or 3, SAME zero
padding) of the NHWC input ``x``, and optionally of a second input ``x2``
whose channels follow ``x``'s (a split convolution, one launch with two
accumulators):

    x_q = rint(clamp(x / in_scale, -127, 127))         (f32 division, ties to even)
    acc = conv(x_q, w_q)                               (int32, exact)
    y   = f32(acc) * (in_scale * s_w)  [+ f32(acc2) * (in_scale2 * s_w2)]  [+ bias]

each product and sum rounded on its own, cast to ``out_dtype`` (x's dtype
by default): the JAX package's rounding points
(``probunet_tpu/models/layers.py:215-229``). The weights arrive quantized
per output channel as a :class:`QWeight` (:func:`quantize_weight`), per
slice of a split convolution.

The plain version quantizes in torch and convolves the int8 values in
float64, which is exact (every partial sum stays below 2**53), then
converts the sums to int32 and applies the same epilogue op by op. CPU
tensors take it; CUDA tensors launch kernel E or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/int8_conv.cu"
REPLACES = "no TPU kernel: XLA's int8 convolution at probunet_tpu/ops/quantize.py:70"

QMAX = 127.0
_CHUNK = 32   # the kernel's K step: input channels padded to a multiple


class QWeight(NamedTuple):
    """A weight quantized per output channel: ``q`` (cout, cin, k, k) int8,
    ``scale`` (cout,) f32, and ``words``, ``q`` in the kernel's layout
    ((cout, k*k, ceil(cin / 32) * 8) int32, four input channels a word,
    zero-padded)."""

    q: torch.Tensor
    scale: torch.Tensor
    words: torch.Tensor


def over_qmax(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE f32 division on any device: a CUDA tensor
    divided by a Python number is multiplied by the number's reciprocal,
    which can be one ulp off the JAX package's quotient."""
    return t / torch.full((), QMAX, dtype=torch.float32, device=t.device)


def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric scales of an OIHW weight: the absmax
    over (I, H, W) in f32, floored at 1e-12, over 127."""
    absmax = w.detach().float().abs().amax(dim=tuple(range(1, w.dim())))
    return over_qmax(absmax.clamp_min(1e-12))


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8; the division in f32,
    ties to even."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def pack_words(q: torch.Tensor) -> torch.Tensor:
    """(cout, cin, k, k) int8 -> (cout, k*k, ceil(cin / 32) * 8) int32."""
    cout, cin, k, _ = q.shape
    hwio = q.permute(0, 2, 3, 1).reshape(cout, k * k, cin)
    pad = (-cin) % _CHUNK
    if pad:
        hwio = F.pad(hwio, (0, pad))
    return hwio.contiguous().view(torch.int32)


def quantize_weight(w: torch.Tensor) -> QWeight:
    """``w`` (OIHW, any float type) quantized per output channel."""
    scale = weight_scales(w)
    q = quantize_int8(w.detach(), scale[:, None, None, None])
    return QWeight(q, scale, pack_words(q))


def int8_acc_plain(x: torch.Tensor, in_scale, q: torch.Tensor) -> torch.Tensor:
    """The int32 sums (N, H, W, cout) of the NHWC ``x`` quantized with
    ``in_scale`` against the int8 weight ``q``: a float64 convolution of
    the int8 values, exact, converted to int32."""
    x_q = quantize_int8(x, in_scale).permute(0, 3, 1, 2)
    acc = F.conv2d(x_q.double(), q.double(), padding=q.shape[-1] // 2)
    return acc.to(torch.int32).permute(0, 2, 3, 1)


def _rescale(acc: torch.Tensor, in_scale, scale: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(in_scale, dtype=torch.float32, device=acc.device) * scale
    return acc.float() * s


def int8_conv_plain(x, qw: QWeight, in_scale, bias=None, x2=None, qw2: QWeight | None = None,
                    in_scale2=None, out_dtype=None, return_acc: bool = False):
    """The plain PyTorch version of :func:`int8_conv`."""
    acc = [int8_acc_plain(x, in_scale, qw.q)]
    y = _rescale(acc[0], in_scale, qw.scale)
    if x2 is not None:
        acc.append(int8_acc_plain(x2, in_scale2, qw2.q))
        y = y + _rescale(acc[1], in_scale2, qw2.scale)
    if bias is not None:
        y = y + bias.float()
    y = y.to(out_dtype or x.dtype).contiguous()
    return (y, torch.stack(acc)) if return_acc else y


def _check(x: torch.Tensor, qw: QWeight, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: {name} on {x.device}; the kernel needs a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv: {name} must be f32 or bf16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"int8_conv: {name} (shape {tuple(x.shape)}, strides {x.stride()}) "
                         "must be a row-major NHWC tensor")
    cout, cin, k, k2 = qw.q.shape
    if k != k2 or k not in (1, 3) or x.shape[3] != cin:
        raise ValueError(f"int8_conv: {name} {tuple(x.shape)} against a weight "
                         f"{tuple(qw.q.shape)}; the kernel takes 1x1 or 3x3 on the last axis")
    words = (cout, k * k, (cin + _CHUNK - 1) // _CHUNK * (_CHUNK // 4))
    for t, what, dt, shape in ((qw.words, "words", torch.int32, words),
                               (qw.scale, "scale", torch.float32, (cout,))):
        if (t.device != x.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"int8_conv: {name}'s weight {what} must be a contiguous {dt} "
                             f"{shape} tensor on {x.device}")


def _launch(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc):
    _check(x, qw, "x")
    n, h, w, _ = x.shape
    cout, _, k, _ = qw.q.shape
    if x2 is not None:
        _check(x2, qw2, "x2")
        if x2.shape[:3] != x.shape[:3] or x2.dtype != x.dtype or qw2.q.shape[0] != cout \
                or qw2.q.shape[2] != k:
            raise ValueError(f"int8_conv: x2 {tuple(x2.shape)} {x2.dtype} does not pair with "
                             f"x {tuple(x.shape)} {x.dtype}")
    if bias is not None and (bias.device != x.device or bias.dtype != torch.float32
                             or tuple(bias.shape) != (cout,) or not bias.is_contiguous()):
        raise ValueError(f"int8_conv: bias must be a contiguous f32 ({cout},) tensor on "
                         f"{x.device}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv: out_dtype must be f32 or bf16, got {out_dtype}")
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    acc = (torch.empty((1 if x2 is None else 2, n, h, w, cout), dtype=torch.int32,
                       device=x.device) if return_acc else None)
    two = x2 is not None
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.int8_conv_fwd(
            x.data_ptr(), qw.words.data_ptr(), qw.scale.data_ptr(), float(in_scale), x.shape[3],
            x2.data_ptr() if two else None, qw2.words.data_ptr() if two else None,
            qw2.scale.data_ptr() if two else None, float(in_scale2) if two else 0.0,
            x2.shape[3] if two else 0, bias.data_ptr() if bias is not None else None,
            y.data_ptr(), acc.data_ptr() if acc is not None else None, n, h, w, cout, k,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_conv_fwd")
    int8_conv.launches += 1
    return (y, acc) if return_acc else y


def int8_conv(x: torch.Tensor, qw: QWeight, in_scale, bias: torch.Tensor | None = None,
              x2: torch.Tensor | None = None, qw2: QWeight | None = None, in_scale2=None,
              out_dtype: torch.dtype | None = None, return_acc: bool = False):
    """The quantized convolution of the NHWC ``x`` (and ``x2``), SAME
    padding, k from the weight (1 or 3): (N, H, W, cout) in ``out_dtype``
    (x's dtype by default); with ``return_acc`` also the int32 sums, stacked
    (1 or 2, N, H, W, cout). ``in_scale``/``in_scale2``: Python floats or
    0-d f32 tensors (a CUDA tensor is read back to the host). No gradient.

    CPU tensors take :func:`int8_conv_plain`; CUDA tensors launch kernel E
    (f32 or bf16, row-major NHWC) or raise."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc)
    return _launch(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc)


int8_conv.launches = 0
