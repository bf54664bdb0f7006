"""Ensemble CRPS terms: CUDA kernel (``csrc/afcrps.cu``) and plain version.

Port of ``probunet_tpu/ops/pallas/afcrps.py`` (forward only):

    t1(b) = sum_{j, p}   |x_bjp - y_bp|
    t2(b) = sum_{j<k, p} |x_bjp - x_bkp|

for ens x (B, M, P) and target y (B, P), returned as two (B,) f32
tensors. Differences are taken in the input dtype (bf16 or f32) and
summed in f32, as in the TPU kernel. The analytic backward (the TPU's
``_terms_bwd_impl``) is not ported yet: a CUDA call on tensors that
require grad raises.
"""

from __future__ import annotations

import torch

from probunet_tpu_torch.ops import losses
from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/afcrps.cu"
REPLACES = "probunet_tpu/ops/pallas/afcrps.py:118"


def ensemble_crps_terms_plain(ens: torch.Tensor, tgt: torch.Tensor):
    """The plain PyTorch version: pairwise for M <= 32, sorted above."""
    t1 = torch.abs(ens - tgt[:, None, :]).sum(dim=(1, 2), dtype=torch.float32)
    return t1, losses._ensemble_spread_sum(ens)


def ensemble_crps_terms(ens: torch.Tensor, tgt: torch.Tensor):
    """(t1, t2) per batch element; ens (B, M, P), tgt (B, P).

    CPU tensors take :func:`ensemble_crps_terms_plain`; CUDA tensors launch
    the kernel (f32 or bf16, contiguous, 1 <= M <= 32) or raise.
    """
    if ens.device.type == "cpu" and tgt.device.type == "cpu":
        return ensemble_crps_terms_plain(ens, tgt)
    return _launch(ens, tgt)


ensemble_crps_terms.launches = 0


def _launch(ens: torch.Tensor, tgt: torch.Tensor):
    if ens.device.type != "cuda" or tgt.device != ens.device:
        raise ValueError(f"ensemble_crps_terms: ens on {ens.device}, tgt on "
                         f"{tgt.device}; the kernel needs both on one CUDA device")
    if torch.is_grad_enabled() and (ens.requires_grad or tgt.requires_grad):
        raise NotImplementedError(
            "ensemble_crps_terms has no CUDA backward yet; call it under "
            "torch.no_grad() or with tensors that do not require grad")
    if ens.dim() != 3 or tgt.dim() != 2 or tuple(tgt.shape) != (ens.shape[0], ens.shape[2]):
        raise ValueError(f"ens must be (B, M, P) and tgt (B, P); got "
                         f"{tuple(ens.shape)} and {tuple(tgt.shape)}")
    if ens.dtype not in (torch.float32, torch.bfloat16) or tgt.dtype != ens.dtype:
        raise ValueError(f"ens/tgt dtypes {ens.dtype}/{tgt.dtype}: the kernel "
                         "takes both f32 or both bf16")
    if not (ens.is_contiguous() and tgt.is_contiguous()):
        raise ValueError("ensemble_crps_terms: ens and tgt must be contiguous")
    lib = _build.library()
    b, m, p = ens.shape
    if not 1 <= m <= lib.afcrps_max_members():
        raise ValueError(f"M={m} outside the kernel's 1..{lib.afcrps_max_members()}")
    if not 1 <= b <= 65535:
        raise ValueError(f"B={b} outside the kernel's 1..65535")
    ntiles = -(-p // lib.afcrps_tile_pixels())
    with torch.cuda.device(ens.device):
        partial = torch.empty((2, b, ntiles), dtype=torch.float32, device=ens.device)
        t1 = torch.empty(b, dtype=torch.float32, device=ens.device)
        t2 = torch.empty(b, dtype=torch.float32, device=ens.device)
        err = lib.afcrps_terms_fwd(
            ens.data_ptr(), tgt.data_ptr(), partial.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), b, m, p, int(ens.dtype == torch.bfloat16),
            torch.cuda.current_stream(ens.device).cuda_stream)
    _build.check(err, "afcrps_terms_fwd")
    ensemble_crps_terms.launches += 1
    return t1, t2
