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
tensors take it; CUDA tensors launch kernel E on the route :func:`plan`
gives their shape, or raise:

- ``"wgmma"``: a TMA ring feeding s8 ``wgmma``, each input element
  quantized once, a block owning all output channels of a 128-pixel tile
  (up to 256; 128 for a split convolution's two accumulators), for every
  input whose rows TMA can address;
- ``"mma_sync"``: the first design (``mma.sync`` m16n8k32, 64 pixels by 32
  channels a block), for the rest: the flagship's cin = 3 and cin = 6 first
  convolutions.

Both read the weights as :func:`pack_words` lays them out: the exact
shared-memory image of the ``wgmma`` B operand.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/int8_conv.cu"
REPLACES = "no TPU kernel: XLA's int8 convolution at probunet_tpu/ops/quantize.py:70"

QMAX = 127.0
_CHUNK = 32   # the kernel's K step: input channels padded to a multiple
N_TILES = (32, 64, 128, 256)   # output channels a block of the "wgmma" route

# Route "wgmma"'s geometry and shared memory (csrc/int8_conv.cu:geometry):
# 128 output pixels a block, three int8 tiles, the epilogue's staging, at
# most four ring stages; a block may take 227 KB, two blocks 2 x 113 KB of
# an SM's 228 KB (1 KB a block is the runtime's).
TILE_PIXELS = 128
_Q_BUFS = 3
_EPI_BYTES = 2 * 64 * 160
_STAGES_MAX = 4
_SMEM_BLOCK = 232448
_SMEM_SM = 233472


class QWeight(NamedTuple):
    """A weight quantized per output channel: ``q`` (cout, cin, k, k) int8,
    ``scale`` (cout,) f32, and ``words``, ``q`` in the kernel's layout
    (:func:`pack_words`)."""

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


def block_channels(cout: int, two: bool = False) -> int:
    """Output channels a block of route "wgmma" owns: the least of
    :data:`N_TILES` that holds all of ``cout``, up to 256 (128 for a split
    convolution, whose two accumulators of 64 x n_tile s32 must fit a
    thread's registers); wider outputs take several blocks."""
    want = min(cout, 128 if two else 256)
    return next(n for n in N_TILES if n >= want)


def pack_words(q: torch.Tensor, n_tile: int) -> torch.Tensor:
    """(cout, cin, k, k) int8 -> (cout_blocks, cin_chunks, k*k, 2, n_tile, 4)
    int32: for each block of ``n_tile`` output channels, chunk of 32 input
    channels and tap, the slab [k half][output channel][16 input channels]
    of int8 (four channels a word), zero-padded in both channel counts. A
    slab of all taps is the shared-memory image of the ``wgmma`` B operand
    (K-major, no swizzle: 16-byte core-matrix rows), so the kernel moves it
    with one bulk copy."""
    cout, cin, k, _ = q.shape
    blocks, chunks = -(-cout // n_tile), -(-cin // _CHUNK)
    t = q.permute(0, 2, 3, 1).reshape(cout, k * k, cin)
    t = F.pad(t, (0, chunks * _CHUNK - cin, 0, 0, 0, blocks * n_tile - cout))
    t = t.reshape(blocks, n_tile, k * k, chunks, 2, 16).permute(0, 3, 2, 4, 1, 5)
    return t.contiguous().view(torch.int32)


def quantize_weight(w: torch.Tensor, n_tile: int | None = None) -> QWeight:
    """``w`` (OIHW, any float type) quantized per output channel, packed for
    blocks of ``n_tile`` output channels (default :func:`block_channels` of
    an unsplit convolution; a split convolution's slices take
    ``block_channels(cout, True)``)."""
    scale = weight_scales(w)
    q = quantize_int8(w.detach(), scale[:, None, None, None])
    return QWeight(q, scale, pack_words(q, n_tile or block_channels(w.shape[0])))


class Plan(NamedTuple):
    """How kernel E runs one shape (:func:`plan`)."""

    route: str          # "wgmma" or "mma_sync"
    n_tile: int         # output channels a block (of the weight slabs)
    tile_w: int         # "wgmma", k = 3: columns of a tile (16 or 8); else 8
    stages: int         # "wgmma": ring stages
    smem: int           # "wgmma": dynamic shared memory of a block, bytes
    blocks_per_sm: int  # "wgmma": blocks an SM holds in that memory (1 or 2)


def _r128(v: int) -> int:
    return -(-v // 128) * 128


@functools.lru_cache(maxsize=None)
def plan(k: int, cin: int, cin2: int, cout: int, h: int, w: int, dtype: torch.dtype) -> Plan:
    """The route and tile of kernel E for a k x k convolution of an (N, h, w,
    cin) input [and a second of cin2 channels; 0 for none] to cout
    channels in ``dtype`` (f32 or bf16), chosen from the shape before any
    launch.

    Rule: route "wgmma" wherever TMA can address the input rows (cin and
    cin2 times the element size multiples of 16 bytes) and cout % 8 == 0;
    route "mma_sync" for the rest. On the flagship that is every
    convolution of the sample and eval paths but the U-Net's and prior's
    cin = 3 first convolutions and the posterior's cin = 6 one. A block
    owns :func:`block_channels` output channels of a 128-pixel tile, 8 x
    16 for k = 3 (16 x 8 on images 8 or fewer pixels wide), and its two
    warpgroups 64 pixels each. The ring takes as many stages (2 to 4) as
    fit beside the fixed buffers: in half an SM's shared memory where the
    accumulators (n_tile x inputs) are 64 columns or fewer and two blocks
    share an SM, else in a block's 227 KB.

    Chip readings (H100 80GB HBM3, 700 W; throwaway variants of the kernel
    and chip_smoke.py, PERF.md §6): the first design spent 0.56 of its
    0.4766 ms at 128x128x32 -> 32 (bs=128 bf16) quantizing and restaging,
    0.43 in its scattered 2-byte stores and 0.15 in its MMAs, so the wgmma
    route takes every shape it can address (0.2198 ms there, cuDNN's bf16
    convolution 0.2120). Two tile shapes measured no faster there and were
    dropped: warpgroups on 64-pixel tiles of their own (0.2296 ms; slower
    at 64 output channels, one block an SM) and 256-pixel tiles at 32
    output channels (0.2674 ms). The returned tuple is cached: it is
    immutable."""
    es = 2 if dtype == torch.bfloat16 else 4
    two = cin2 > 0
    nt = block_channels(cout, two)
    if k not in (1, 3) or cout % 8 or any(c * es % 16 for c in (cin, cin2) if c):
        return Plan("mma_sync", nt, 8, 0, 0, 0)
    tile_w = 16 if k == 3 and w > 8 else 8
    slots = (TILE_PIXELS // tile_w + 2) * (tile_w + 2) if k == 3 else TILE_PIXELS
    stage = _r128(slots * _CHUNK * es) + _r128(k * k * _CHUNK * nt) + 16   # + its 2 barriers
    q_lbo = slots * 16 if slots * 16 % 128 == 64 else _r128(slots * 16) + 64
    fixed = 128 + _Q_BUFS * _r128(2 * q_lbo) + _EPI_BYTES
    for per_sm in (2, 1) if nt * (1 + two) <= 64 else (1,):
        budget = min(_SMEM_BLOCK, _SMEM_SM // per_sm - 1024)
        stages = min(_STAGES_MAX, (budget - fixed) // stage)
        if stages >= 2:
            return Plan("wgmma", nt, tile_w, stages, fixed + stages * stage, per_sm)
    return Plan("mma_sync", nt, 8, 0, 0, 0)


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
    nt = qw.words.shape[4] if qw.words.dim() == 6 else 0
    words = (-(-cout // nt) if nt else 0, -(-cin // _CHUNK), k * k, 2, nt, 4)
    for t, what, dt, shape in ((qw.words, "words", torch.int32, words),
                               (qw.scale, "scale", torch.float32, (cout,))):
        if (t.device != x.device or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"int8_conv: {name}'s weight {what} must be a contiguous {dt} "
                             f"{shape} tensor on {x.device}")


def _entry_args(x, qw, in_scale, bias, x2, qw2, in_scale2, y, acc) -> tuple:
    """The arguments the two C entries share."""
    n, h, w, _ = x.shape
    cout, _, k, _ = qw.q.shape
    two = x2 is not None
    return (x.data_ptr(), qw.words.data_ptr(), qw.scale.data_ptr(), float(in_scale), x.shape[3],
            x2.data_ptr() if two else None, qw2.words.data_ptr() if two else None,
            qw2.scale.data_ptr() if two else None, float(in_scale2) if two else 0.0,
            x2.shape[3] if two else 0, bias.data_ptr() if bias is not None else None,
            y.data_ptr(), acc.data_ptr() if acc is not None else None, n, h, w, cout, k,
            int(x.dtype == torch.bfloat16), int(y.dtype == torch.bfloat16))


def launch_wgmma(args: tuple, pl: Plan, stream: int) -> None:
    """Route "wgmma" (``int8_conv_wgmma_kernel``) on :func:`_entry_args`."""
    err = _build.library().int8_conv_wgmma(*args, pl.n_tile, pl.tile_w, pl.stages, stream)
    _build.check(err, "int8_conv_wgmma")
    launch_wgmma.launches += 1


def launch_mma_sync(args: tuple, pl: Plan, stream: int) -> None:
    """Route "mma_sync" (``int8_conv_kernel``) on :func:`_entry_args`."""
    err = _build.library().int8_conv_fwd(*args, pl.n_tile, stream)
    _build.check(err, "int8_conv_fwd")
    launch_mma_sync.launches += 1


launch_wgmma.launches = 0
launch_mma_sync.launches = 0
_ROUTES = {"wgmma": launch_wgmma, "mma_sync": launch_mma_sync}


def _launch(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc, route=None):
    """Check the inputs and launch kernel E on the route :func:`plan` gives
    the shape (``route``: "mma_sync" forces the first design, for
    comparison; "wgmma" on a shape it does not take raises)."""
    _check(x, qw, "x")
    n, h, w, cin = x.shape
    cout, _, k, _ = qw.q.shape
    two = x2 is not None
    if two:
        _check(x2, qw2, "x2")
        if x2.shape[:3] != x.shape[:3] or x2.dtype != x.dtype or qw2.q.shape[0] != cout \
                or qw2.q.shape[2] != k:
            raise ValueError(f"int8_conv: x2 {tuple(x2.shape)} {x2.dtype} does not pair with "
                             f"x {tuple(x.shape)} {x.dtype}")
    pl = plan(k, cin, x2.shape[3] if two else 0, cout, h, w, x.dtype)
    for t in (qw, qw2) if two else (qw,):
        if t.words.shape[4] != pl.n_tile:
            raise ValueError(f"int8_conv: weights packed for {t.words.shape[4]} output channels "
                             f"a block; this shape takes {pl.n_tile} "
                             f"(quantize_weight(w, block_channels({cout}, {two})))")
    route = route or pl.route
    if route not in _ROUTES or (route == "wgmma" and pl.route != "wgmma"):
        raise ValueError(f"int8_conv: route {route!r} does not take {tuple(x.shape)} -> {cout}")
    if bias is not None and (bias.device != x.device or bias.dtype != torch.float32
                             or tuple(bias.shape) != (cout,) or not bias.is_contiguous()):
        raise ValueError(f"int8_conv: bias must be a contiguous f32 ({cout},) tensor on "
                         f"{x.device}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_conv: out_dtype must be f32 or bf16, got {out_dtype}")
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x.device)
    acc = (torch.empty((2 if two else 1, n, h, w, cout), dtype=torch.int32,
                       device=x.device) if return_acc else None)
    with torch.cuda.device(x.device):
        _ROUTES[route](_entry_args(x, qw, in_scale, bias, x2, qw2, in_scale2, y, acc), pl,
                       torch.cuda.current_stream(x.device).cuda_stream)
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
    on the route of :func:`plan` (f32 or bf16, row-major NHWC) or raise.
    ``qw``/``qw2`` come from :func:`quantize_weight` with
    ``block_channels(cout, x2 is not None)``."""
    if x.device.type == "cpu":
        return int8_conv_plain(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc)
    return _launch(x, qw, in_scale, bias, x2, qw2, in_scale2, out_dtype, return_acc)


int8_conv.launches = 0
