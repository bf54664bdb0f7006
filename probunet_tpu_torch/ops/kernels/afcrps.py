"""Ensemble CRPS terms: CUDA kernel (``csrc/afcrps.cu``) and plain version.

Port of ``probunet_tpu/ops/pallas/afcrps.py``, forward (kernel B) and
analytic backward (kernel B′, ``afcrps_terms_bwd`` in the same source):

    t1(b) = sum_{j, p}   |x_bjp - y_bp|
    t2(b) = sum_{j<k, p} |x_bjp - x_bkp|

for ens x (B, M, P) and target y (B, P), returned as two (B,) f32
tensors. Differences are taken in the input dtype (bf16 or f32) and
summed in f32, as in the TPU kernel. :func:`ensemble_crps_terms` is a
``torch.autograd.Function`` whose backward, given (g1, g2) per batch
element, is

    dx_j = g1 * sign(x_j - y) + g2 * sum_{k != j} sign(x_j - x_k)
    dy   = -g1 * sum_j sign(x_j - y)

with the signs taken in f32 of the input-dtype difference; dx and dy come
back in the inputs' dtype.

The kernels read ens at its own batch and member strides (its pixel
stride must be 1), so ``Fcomb.ensemble``'s member-major view is scored in
place; B′ writes dx in ens's layout (``torch.empty_like``), so autograd
hands it back to the view uncopied. Any M >= 1 and any B launch.
"""

from __future__ import annotations

import torch

from probunet_tpu_torch.ops import losses
from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/afcrps.cu"
REPLACES = "probunet_tpu/ops/pallas/afcrps.py:118"
REPLACES_BWD = "probunet_tpu/ops/pallas/afcrps.py:155"


def ensemble_crps_terms_plain(ens: torch.Tensor, tgt: torch.Tensor):
    """The plain PyTorch version: pairwise for M <= 32, sorted above."""
    t1 = torch.abs(ens - tgt[:, None, :]).sum(dim=(1, 2), dtype=torch.float32)
    return t1, losses._ensemble_spread_sum(ens)


def ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2):
    """The plain PyTorch backward: (dx (B, M, P), dy (B, P)) in ens's and
    tgt's dtypes, pair signs one distance d = k - j at a time."""
    m = ens.shape[1]
    s0 = torch.sign((ens - tgt[:, None, :]).float())              # (B, M, P)
    count = torch.zeros_like(s0)
    for d in range(1, m):
        s = torch.sign((ens[:, : m - d] - ens[:, d:]).float())
        count[:, : m - d] += s
        count[:, d:] -= s
    g1 = g1.float()[:, None, None]
    g2 = g2.float()[:, None, None]
    dx = g1 * s0 + g2 * count
    dy = -g1[:, :, 0] * s0.sum(dim=1)
    return dx.to(ens.dtype), dy.to(tgt.dtype)


def ensemble_crps_terms_fwd(ens: torch.Tensor, tgt: torch.Tensor):
    """(t1, t2) without autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (f32 or bf16, ens's pixel stride 1, tgt
    contiguous)."""
    if ens.device.type == "cpu" and tgt.device.type == "cpu":
        return ensemble_crps_terms_plain(ens, tgt)
    return _launch(ens, tgt)


def ensemble_crps_terms_bwd(ens, tgt, g1, g2):
    """(dx, dy): the plain backward for CPU tensors, kernel B′ for CUDA."""
    if all(t.device.type == "cpu" for t in (ens, tgt, g1, g2)):
        return ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2)
    return _launch_bwd(ens, tgt, g1, g2)


ensemble_crps_terms_bwd.launches = 0


class _Terms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ens, tgt):
        ctx.save_for_backward(ens, tgt)
        return ensemble_crps_terms_fwd(ens, tgt)

    @staticmethod
    def backward(ctx, g1, g2):
        ens, tgt = ctx.saved_tensors
        dx, dy = ensemble_crps_terms_bwd(ens, tgt, g1.contiguous(), g2.contiguous())
        return dx, (dy if ctx.needs_input_grad[1] else None)


def ensemble_crps_terms(ens: torch.Tensor, tgt: torch.Tensor):
    """(t1, t2) per batch element; ens (B, M, P), tgt (B, P). Differentiable
    (analytic backward).

    CPU tensors take the plain versions; CUDA tensors launch kernels B and
    B′ (f32 or bf16, ens's pixel stride 1, tgt contiguous) or raise.
    """
    return _Terms.apply(ens, tgt)


ensemble_crps_terms.launches = 0


def _check(ens: torch.Tensor, tgt: torch.Tensor, what: str) -> None:
    if ens.device.type != "cuda" or tgt.device != ens.device:
        raise ValueError(f"{what}: ens on {ens.device}, tgt on "
                         f"{tgt.device}; the kernel needs both on one CUDA device")
    if ens.dim() != 3 or tgt.dim() != 2 or tuple(tgt.shape) != (ens.shape[0], ens.shape[2]):
        raise ValueError(f"ens must be (B, M, P) and tgt (B, P); got "
                         f"{tuple(ens.shape)} and {tuple(tgt.shape)}")
    if ens.dtype not in (torch.float32, torch.bfloat16) or tgt.dtype != ens.dtype:
        raise ValueError(f"ens/tgt dtypes {ens.dtype}/{tgt.dtype}: the kernel "
                         "takes both f32 or both bf16")
    if not (pixels_unit_stride(ens) and tgt.is_contiguous()):
        raise ValueError(f"{what}: ens needs pixel stride 1 (got strides {ens.stride()}) "
                         "and tgt must be contiguous")


def pixels_unit_stride(ens: torch.Tensor) -> bool:
    """Whether the kernels read (B, M, P) ``ens`` in place: pixel stride 1."""
    return ens.stride(2) == 1 or ens.shape[2] == 1


def _launch(ens: torch.Tensor, tgt: torch.Tensor):
    _check(ens, tgt, "ensemble_crps_terms")
    lib = _build.library()
    b, m, p = ens.shape
    ntiles = -(-p // lib.afcrps_tile_pixels())
    with torch.cuda.device(ens.device):
        partial = torch.empty((2, b, ntiles), dtype=torch.float32, device=ens.device)
        t1 = torch.empty(b, dtype=torch.float32, device=ens.device)
        t2 = torch.empty(b, dtype=torch.float32, device=ens.device)
        err = lib.afcrps_terms_fwd(
            ens.data_ptr(), tgt.data_ptr(), partial.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), b, m, p, ens.stride(0), ens.stride(1),
            int(ens.dtype == torch.bfloat16), torch.cuda.current_stream(ens.device).cuda_stream)
    _build.check(err, "afcrps_terms_fwd")
    ensemble_crps_terms.launches += 1
    return t1, t2


def _launch_bwd(ens, tgt, g1, g2):
    _check(ens, tgt, "ensemble_crps_terms_bwd")
    b, m, p = ens.shape
    for name, g in (("g1", g1), ("g2", g2)):
        if g.device != ens.device or g.dtype != torch.float32 or tuple(g.shape) != (b,):
            raise ValueError(f"{name} must be a ({b},) f32 tensor on {ens.device}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")
    lib = _build.library()
    with torch.cuda.device(ens.device):
        dx = torch.empty_like(ens)  # ens's strides where ens is dense, else contiguous
        dy = torch.empty_like(tgt)
        err = lib.afcrps_terms_bwd(
            ens.data_ptr(), tgt.data_ptr(), g1.data_ptr(), g2.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), b, m, p, ens.stride(0), ens.stride(1), dx.stride(0), dx.stride(1),
            int(ens.dtype == torch.bfloat16), torch.cuda.current_stream(ens.device).cuda_stream)
    _build.check(err, "afcrps_terms_bwd")
    ensemble_crps_terms_bwd.launches += 1
    return dx, dy
