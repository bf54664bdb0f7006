"""The ELBOs' reconstruction losses (port of ``probunet_tpu/ops/losses.py``):
the ensemble CRPS losses, their O(M^2) oracles, WMSE + MS-SSIM and L1.

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
cover all trailing axes. WMSE + MS-SSIM and L1 take NHWC predictions and
plain torch operations (the JAX package computes them with XLA, outside
any TPU kernel). Every loss takes ``rows`` (``parallel.spatial.Rows``):
its inputs are then this rank's block of image rows, and its value is the
whole image's, alike on every rank.
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


def _terms_over_rows(ensemble: torch.Tensor, target: torch.Tensor, rows):
    """(t1, t2, pixel count): the terms of the block's pixels, and with
    ``rows`` (this rank's block of rows, ``parallel.spatial.Rows``) summed
    over the ranks (differentiably; the JAX package's ``psum`` over
    "spatial", ``ops/pallas/partition.py``) with the global pixel count."""
    p = math.prod(ensemble.shape[2:])
    ens = _flatten_spatial(ensemble, 2)
    tgt = _flatten_spatial(target, 1)[:, None, :]
    t1, t2 = _crps_terms(ens, tgt)
    if rows is not None:
        t1, t2 = rows.sum(torch.stack([t1, t2]))
        p *= rows.parts
    return t1, t2, p


def afcrps_loss(ensemble: torch.Tensor, target: torch.Tensor,
                alpha: float = 0.95, rows=None) -> torch.Tensor:
    """Almost-fair CRPS, mean over batch and pixels:
    1/[2M(M-1)] sum_{j != k} (|x_j - y| + |x_k - y| - (1-eps)|x_j - x_k|)
    with eps = (1 - alpha)/M. ``rows``: the inputs are a block of rows."""
    m = ensemble.shape[1]
    if m < 2:
        raise ValueError(f"M must be >= 2 for afCRPS, got M={m}")
    t1, t2, p = _terms_over_rows(ensemble, target, rows)
    return afcrps_from_terms(t1, t2, m, p, alpha)


def crps_loss(ensemble: torch.Tensor, target: torch.Tensor, rows=None) -> torch.Tensor:
    """Ensemble CRPS: E|x - y| - 0.5 E|x - x'| over ordered pairs, averaged
    over batch and pixels. ``rows``: the inputs are a block of rows."""
    m = ensemble.shape[1]
    t1, t2, p = _terms_over_rows(ensemble, target, rows)
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


def afcrps_loss_pairwise(ensemble: torch.Tensor, target: torch.Tensor,
                         alpha: float = 0.95) -> torch.Tensor:
    """The literal O(M^2) afCRPS, the reference's tensor algebra: a test
    oracle."""
    m = ensemble.shape[1]
    eps = (1.0 - alpha) / m
    p = math.prod(ensemble.shape[2:])
    ens = _flatten_spatial(ensemble, 2)
    tgt = _flatten_spatial(target, 1)[:, None, :]
    xy = torch.abs(ens - tgt)                                   # (B, M, P)
    term_jy_ky = xy[:, :, None, :] + xy[:, None, :, :]          # (B, M, M, P)
    term_jk = (1.0 - eps) * torch.abs(ens[:, :, None, :] - ens[:, None, :, :])
    mask = (1.0 - torch.eye(m, dtype=ensemble.dtype, device=ensemble.device)).reshape(
        1, m, m, 1)
    s = torch.sum((term_jy_ky - term_jk) * mask, dim=(1, 2, 3))
    return (s / (2.0 * m * (m - 1)) / p).mean()


def crps_loss_pairwise(ensemble: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The literal O(M^2) ensemble CRPS: a test oracle."""
    ens = _flatten_spatial(ensemble, 2)
    tgt = _flatten_spatial(target, 1)[:, None, :]
    first = torch.abs(ens - tgt).mean(dim=1)                               # (B, P)
    second = torch.abs(ens[:, :, None, :] - ens[:, None, :, :]).mean(dim=(1, 2))
    return (first - 0.5 * second).mean()


def wmse_weights(target: torch.Tensor, alpha: float = 0.007,
                 beta: float = 0.048) -> torch.Tensor:
    """w(y) = min(alpha * exp(beta * y), 1)."""
    return torch.clamp(alpha * torch.exp(beta * target), max=1.0)


def _mean(t: torch.Tensor, rows=None, dim=None) -> torch.Tensor:
    """The mean of ``t`` over ``dim`` (every axis with None); with ``rows``
    (``t`` a block of image rows) the block's sum summed over the ranks
    (differentiably) and divided by the global count."""
    if rows is None:
        return torch.mean(t) if dim is None else torch.mean(t, dim=dim)
    total = t.sum() if dim is None else t.sum(dim=dim)
    return rows.sum(total) / (t.numel() // total.numel() * rows.parts)


def wmse_ms_ssim_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.007,
                      beta: float = 0.048, lam: float = 0.0,
                      return_components: bool = False, data_range=None, rows=None):
    """lam * WMSE + (1 - lam) * (1 - MS-SSIM) of (B, H, W, C) tensors; a
    (B, M, H, W, C) ensemble collapses to its mean, as in the reference.
    ``data_range`` defaults to the target's max - min of this call, at
    least 1e-5. MS-SSIM takes win_size 7 (sides above 96). ``rows``: the
    inputs are a block of image rows and ``data_range`` must be given (the
    global batch's: the training step computes it)."""
    from probunet_tpu_torch.ops.msssim import ms_ssim

    if pred.dim() == 5:
        pred = pred.mean(dim=1)
    if data_range is None:
        if rows is not None:
            raise ValueError("wmse_ms_ssim_loss of a block of rows needs the global "
                             "batch's data_range")
        data_range = torch.clamp(target.max() - target.min(), min=1e-5)
    w = wmse_weights(target, alpha=alpha, beta=beta)
    wmse = _mean(w * (pred - target) ** 2, rows)
    msssim_loss = 1.0 - ms_ssim(pred, target, data_range=data_range, win_size=7, rows=rows)
    combined = lam * wmse + (1.0 - lam) * msssim_loss
    if return_components:
        return combined, wmse, msssim_loss
    return combined


def l1_loss(pred: torch.Tensor, target: torch.Tensor, rows=None) -> torch.Tensor:
    """Mean absolute error (the L1 ELBO's reconstruction). ``rows``: the
    inputs are a block of image rows."""
    return _mean(torch.abs(pred - target), rows)


def l1_loss_per_channel(pred: torch.Tensor, target: torch.Tensor, rows=None) -> torch.Tensor:
    """Mean absolute error per channel (last axis, NHWC), for logging.
    ``rows``: the inputs are a block of image rows."""
    return _mean(torch.abs(pred - target), rows, dim=tuple(range(pred.dim() - 1)))
