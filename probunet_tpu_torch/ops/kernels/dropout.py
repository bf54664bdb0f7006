"""Zero-storage inverted dropout: CUDA kernel (``csrc/dropout.cu``) and
plain version.

Port of ``probunet_tpu/ops/pallas/dropout.py``. The mask is a pure
function of (position, two seed words): a murmur3-finalizer hash of the
position inside a (rb, 128) block of the row-major flattened tensor, the
seed words and the block index (``fused_gn._dropout_uniform`` in the JAX
package), evaluated at the TPU kernel's block coordinates. So the masks
equal the JAX kernel's bit for bit, and the backward recomputes the mask
instead of storing it: forward and backward are the same launch, on x
and on the cotangent, and the autograd residual is the (2,) seed tensor.

Element e of the row-major flattened tensor sits at row r = e // 128;
rb = ``_block_rows(rows)``; the hash input is (r % rb) * 128 + e % 128
with salt r // rb. Keep when u = (hash >> 8) * 2**-24 >= p; survivors are
scaled by f32(1 / (1 - p)) in f32.

The U-Net's activations are NCHW views in ``channels_last`` memory, so
the layer hands the NHWC view (``x.permute(0, 2, 3, 1)``), which is
row-major contiguous, and the row-major index is the JAX package's NHWC
index. The kernel wrapper raises on a non-contiguous input instead of
copying it into another order, which would change every mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/dropout.cu"
REPLACES = "probunet_tpu/ops/pallas/dropout.py:100"

_LANE = 128
_MAX_BLOCK_ROWS = 2048  # the TPU kernel's block height limit
_MASK32 = 0xFFFFFFFF


def _block_rows(rows: int) -> int | None:
    """Largest divisor of ``rows`` that is a multiple of 8 and at most 2048
    (the JAX kernel's block height)."""
    best = None
    b = 8
    while b <= min(rows, _MAX_BLOCK_ROWS):
        if rows % b == 0:
            best = b
        b += 8
    return best


def supported(shape) -> bool:
    """Whether the JAX kernel (and so this one) takes a tensor of ``shape``."""
    n = math.prod(shape)
    return n % (8 * _LANE) == 0 and _block_rows(n // _LANE) is not None


def _scale(p_drop: float) -> np.float32:
    return np.float32(1.0 / (1.0 - p_drop))


def _mul32(z: torch.Tensor, m: int) -> torch.Tensor:
    """z * m mod 2**32 for int64 z < 2**32, without int64 overflow."""
    lo = z * (m & 0xFFFF)
    hi = (z * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hash_uniform(pos: torch.Tensor, seed2: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) of ``fused_gn._dropout_uniform`` in the JAX package
    (``csrc/hash.cuh`` on the card): a murmur3 finalizer of (position, seed
    words, salt) in int64 arithmetic masked to 32 bits. ``pos`` and ``salt``
    are int64 tensors that broadcast together; the result is f32."""
    sa, sb = (seed2.to(torch.int64) & _MASK32).unbind()
    z = (pos + _mul32(sa, 2654435761) + sb + salt * 40503) & _MASK32
    for mult in (0x85EBCA6B, 0xC2B2AE35):
        z = _mul32(z ^ (z >> 16), mult)
    z = z ^ (z >> 16)
    return (z >> 8).to(torch.float32) * np.float32(2.0 ** -24)


def dropout_keep(shape, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    """The keep mask (bool, ``shape``): the hash at (rb, 128) block
    coordinates, salted with the block index."""
    n = math.prod(shape)
    rows = n // _LANE
    rb = _block_rows(rows)
    e = torch.arange(n, dtype=torch.int64, device=seed2.device)
    r = e // _LANE
    u = hash_uniform((r % rb) * _LANE + e % _LANE, seed2, r // rb)
    return (u >= np.float32(p_drop)).reshape(shape)


def dropout_plain(x: torch.Tensor, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    """The plain PyTorch version, on the row-major order of ``x``'s shape."""
    keep = dropout_keep(x.shape, seed2, p_drop)
    scaled = x.float() * torch.tensor(_scale(p_drop), device=x.device)
    return torch.where(keep, scaled, torch.zeros((), device=x.device)).to(x.dtype)


def _apply(x: torch.Tensor, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    if not supported(x.shape):
        raise ValueError(f"dropout: shape {tuple(x.shape)} is not supported (numel % 1024 "
                         "!= 0 or no block height); the JAX package would switch mask streams")
    if x.device.type == "cpu" and seed2.device.type == "cpu":
        return dropout_plain(x, seed2, p_drop)
    return _launch(x, seed2, p_drop)


def _launch(x: torch.Tensor, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    if x.device.type != "cuda" or seed2.device != x.device:
        raise ValueError(f"dropout: x on {x.device}, seed2 on {seed2.device}; the "
                         "kernel needs both on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dropout: the kernel takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(
            f"dropout: x (shape {tuple(x.shape)}, strides {x.stride()}) is not "
            "row-major contiguous; the mask follows the row-major index, so pass "
            "the NHWC view of a channels_last activation")
    if seed2.dtype != torch.int32 or tuple(seed2.shape) != (2,) or not seed2.is_contiguous():
        raise ValueError(f"dropout: seed2 must be a contiguous (2,) int32 tensor, got "
                         f"{seed2.dtype} {tuple(seed2.shape)}")
    n = x.numel()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.dropout_apply(x.data_ptr(), y.data_ptr(), seed2.data_ptr(), n,
                                _block_rows(n // _LANE), float(np.float32(p_drop)),
                                float(_scale(p_drop)), int(x.dtype == torch.bfloat16),
                                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dropout_apply")
    dropout.launches += 1
    return y


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed2, p_drop):
        ctx.save_for_backward(seed2)
        ctx.p_drop = p_drop
        return _apply(x, seed2, p_drop)

    @staticmethod
    def backward(ctx, g):
        (seed2,) = ctx.saved_tensors
        # the mask follows the row-major index of the logical shape, so a
        # cotangent in another memory order is first laid out row-major
        return _apply(g.contiguous(), seed2, ctx.p_drop), None, None


def dropout(x: torch.Tensor, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    """Inverted dropout of ``x`` (numel % 1024 == 0) with the hash mask of
    the (2,) int32 ``seed2``; differentiable, storing no mask.

    CPU tensors take :func:`dropout_plain`; CUDA tensors launch the kernel
    (f32 or bf16, row-major contiguous) or raise.
    """
    return _Dropout.apply(x, seed2, float(p_drop))


dropout.launches = 0
