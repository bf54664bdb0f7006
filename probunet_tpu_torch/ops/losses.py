"""Ensemble CRPS losses (port of the afCRPS/CRPS part of
``probunet_tpu/ops/losses.py``).

Both losses reduce to two per-batch sums over the ensemble x (B, M, P)
and target y (B, P):

    t1(b) = sum_{j, p}   |x_bjp - y_bp|
    t2(b) = sum_{j<k, p} |x_bjp - x_bkp|

:func:`_crps_terms` computes them through ``ops.kernels.afcrps``, which
launches the hand-written CUDA kernels for CUDA tensors and runs the plain
form below for CPU tensors: pairwise for M <= ``_PAIRWISE_MAX_M``, the
sorted identity above. Both losses are differentiable: the terms' gradient
is the analytic sign-count backward (kernel B′ on the card), never
autograd through the sort, whose gradient is a scatter.

Ensembles are ``(B, M, *spatial)``, targets ``(B, *spatial)``; reductions
cover all trailing axes.
"""

from __future__ import annotations

import math

import torch

_PAIRWISE_MAX_M = 32


def _flatten_spatial(x: torch.Tensor, lead: int) -> torch.Tensor:
    return x.reshape(*x.shape[:lead], -1)


def _pairwise_abs_sum(ens: torch.Tensor) -> torch.Tensor:
    """sum_{j<k} |x_j - x_k| of (B, M, P) -> (B,) f32, one pair distance
    d = k - j at a time: differences in the input dtype, f32 sums."""
    m = ens.shape[1]
    out = torch.zeros(ens.shape[0], dtype=torch.float32, device=ens.device)
    for d in range(1, m):
        out = out + torch.abs(ens[:, : m - d] - ens[:, d:]).sum(
            dim=(1, 2), dtype=torch.float32)
    return out


def _pairwise_abs_sum_sorted(ens: torch.Tensor) -> torch.Tensor:
    """The same sum by the sorted identity
    sum_{j<k} |x_j - x_k| = sum_i (2i - M + 1) x_(i); forward only."""
    m = ens.shape[1]
    srt = torch.sort(ens, dim=1).values.float()
    coeff = (2.0 * torch.arange(m, dtype=torch.float32, device=ens.device)
             - (m - 1)).reshape(1, m, 1)
    return torch.sum(srt * coeff, dim=(1, 2))


def _ensemble_spread_sum(ens: torch.Tensor) -> torch.Tensor:
    if ens.shape[1] <= _PAIRWISE_MAX_M:
        return _pairwise_abs_sum(ens)
    return _pairwise_abs_sum_sorted(ens)


def _crps_terms(ens: torch.Tensor, tgt: torch.Tensor):
    """(t1, t2) per batch element, f32. ens (B, M, P), tgt (B, 1, P). A view
    with pixel stride 1 (such as ``Fcomb.ensemble``'s member-major output)
    goes to the kernels as it is; any other is copied first."""
    # imported here: the kernel module imports this one for its plain version
    from probunet_tpu_torch.ops.kernels.afcrps import ensemble_crps_terms, pixels_unit_stride

    if not pixels_unit_stride(ens):
        ens = ens.contiguous()
    return ensemble_crps_terms(ens, tgt[:, 0, :].contiguous())


def afcrps_from_terms(t1, t2, m: int, p: int, alpha: float = 0.95) -> torch.Tensor:
    """Batch-mean afCRPS from per-batch terms — shared by
    :func:`afcrps_loss` and the fused fcomb-CRPS path."""
    eps = (1.0 - alpha) / m
    total = 2.0 * (m - 1) * t1 - (1.0 - eps) * 2.0 * t2
    return (total / (2.0 * m * (m - 1)) / p).mean()


def crps_from_terms(t1, t2, m: int, p: int) -> torch.Tensor:
    """Batch-mean ensemble CRPS from per-batch terms."""
    first = t1 / m
    second = 2.0 * t2 / (m * m)  # ordered pairs
    return ((first - 0.5 * second) / p).mean()


def afcrps_loss(ensemble: torch.Tensor, target: torch.Tensor,
                alpha: float = 0.95) -> torch.Tensor:
    """Almost-fair CRPS, mean over batch and pixels:
    1/[2M(M-1)] sum_{j != k} (|x_j - y| + |x_k - y| - (1-eps)|x_j - x_k|)
    with eps = (1 - alpha)/M."""
    m = ensemble.shape[1]
    if m < 2:
        raise ValueError(f"M must be >= 2 for afCRPS, got M={m}")
    p = math.prod(ensemble.shape[2:])
    ens = _flatten_spatial(ensemble, 2)
    tgt = _flatten_spatial(target, 1)[:, None, :]
    t1, t2 = _crps_terms(ens, tgt)
    return afcrps_from_terms(t1, t2, m, p, alpha)


def crps_loss(ensemble: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Ensemble CRPS: E|x - y| - 0.5 E|x - x'| over ordered pairs, averaged
    over batch and pixels."""
    m = ensemble.shape[1]
    p = math.prod(ensemble.shape[2:])
    ens = _flatten_spatial(ensemble, 2)
    tgt = _flatten_spatial(target, 1)[:, None, :]
    t1, t2 = _crps_terms(ens, tgt)
    return crps_from_terms(t1, t2, m, p)


def crps_empirical(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Sort-based per-element CRPS; pred (N, *truth.shape) -> truth.shape."""
    n = pred.shape[0]
    if n == 1:
        return torch.abs(pred[0] - truth)
    srt = torch.sort(pred, dim=0).values
    diff = srt[1:] - srt[:-1]
    weight = (
        torch.arange(1, n, dtype=pred.dtype, device=pred.device)
        * torch.arange(n - 1, 0, -1, dtype=pred.dtype, device=pred.device)
    ).reshape((n - 1,) + (1,) * truth.ndim)
    return torch.abs(pred - truth).mean(dim=0) - torch.sum(diff * weight, dim=0) / n**2
