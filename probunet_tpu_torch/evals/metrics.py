"""Ensemble evaluation metrics (port of ``probunet_tpu/evals/metrics.py``).

- ``crps_over_groundtruth`` — per-variable mean/std over per-timestep
  empirical CRPS of a (T, M, H, W, C) ensemble against (T, H, W, C) ground
  truth (the sort-based estimator of ``ops.losses.crps_empirical``);
- ``compute_mae`` — MAE of the ensemble mean, per variable;
- ``residual_contribution`` — the residual's MAE gain over interpolation;
- ``ensemble_spread`` — per-variable mean member standard deviation.

Inputs are tensors (or numpy arrays, taken onto the CPU); the results stay
on the inputs' device.
"""

from __future__ import annotations

import torch

from probunet_tpu_torch.ops.losses import crps_empirical


def _summary(per_t: torch.Tensor) -> dict[str, torch.Tensor]:
    # std over the per-timestep values with ddof=0, as jnp.std
    return {"mean": per_t.mean(dim=0), "std": per_t.std(dim=0, correction=0),
            "per_timestep": per_t}


def crps_over_groundtruth(ensemble, truth) -> dict[str, torch.Tensor]:
    """Per-variable CRPS summary: {"mean": (C,), "std": (C,),
    "per_timestep": (T, C)}, std over the per-timestep spatial-mean CRPS
    (mean ± std across test days)."""
    ens, gt = torch.as_tensor(ensemble), torch.as_tensor(truth)
    fields = crps_empirical(ens.movedim(1, 0), gt)          # (T, H, W, C)
    return _summary(fields.mean(dim=(1, 2)))


def compute_mae(ensemble, truth) -> dict[str, torch.Tensor]:
    """MAE of the ensemble mean, per variable; the same structure as
    :func:`crps_over_groundtruth`."""
    err = torch.abs(torch.as_tensor(ensemble).mean(dim=1) - torch.as_tensor(truth))
    return _summary(err.mean(dim=(1, 2)))


mae_over_groundtruth = compute_mae


def residual_contribution(pred_hr, lrinterp, hr) -> dict[str, float]:
    """How much the learned residual improves over plain interpolation.

    pred_hr: (T, [M,] H, W, C) model HR prediction (ensemble mean is used);
    lrinterp: (T, H, W, C) interpolation baseline; hr: ground truth.
    """
    p = torch.as_tensor(pred_hr)
    if p.dim() == 5:
        p = p.mean(dim=1)
    hr = torch.as_tensor(hr)
    mae_model = torch.abs(p - hr).mean()
    mae_interp = torch.abs(torch.as_tensor(lrinterp) - hr).mean()
    improvement = 1.0 - mae_model / mae_interp
    return {
        "mae_model": float(mae_model),
        "mae_interp": float(mae_interp),
        "improvement": float(improvement),
    }


def ensemble_spread(ensemble) -> torch.Tensor:
    """Per-variable mean ensemble standard deviation (ddof=1) of a
    (T, M, H, W, C) ensemble — the collapse diagnostic."""
    e = torch.as_tensor(ensemble)
    return e.std(dim=1, correction=1).mean(dim=(0, 1, 2))
