"""ClimEx device-side preprocessing (port of the device half of
``probunet_tpu/data/climex.py``).

Raw HR windows ``(B, H, W, C)`` in storage space become model inputs and
targets on whatever device they live on: LR = AvgPool(k)(HR); per-pixel
LR time statistics lifted to HR by pixel repetition; std with ddof=1;
nearest upsampling by default. Host ingest (NetCDF/packed files) is not
ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from probunet_tpu_torch.ops.resample import avg_pool, repeat_interleave_2d, upsample

PIPELINE_TYPES = (
    "lr_to_hr",
    "lr_to_residuals",
    "lrinterp_to_residuals",
    "lrinterp_to_hr",
)


class Standardization(NamedTuple):
    """Per-pixel statistics: LR (h, w, C) time stats of the pooled fields
    and the same lifted to the HR grid (H, W, C)."""

    lr_mean: torch.Tensor
    lr_std: torch.Tensor
    hr_mean: torch.Tensor
    hr_std: torch.Tensor
    lr_min: torch.Tensor | None = None
    lr_max: torch.Tensor | None = None
    hr_min: torch.Tensor | None = None
    hr_max: torch.Tensor | None = None


def compute_stats(hr: torch.Tensor, lowres_scale: int) -> Standardization:
    """Time mean/std (ddof=1)/min/max of the pooled LR stack (T, H, W, C),
    lifted to HR by pixel repetition."""
    lr = avg_pool(hr, lowres_scale)
    lr_mean = lr.mean(dim=0)
    lr_std = lr.std(dim=0, correction=1)
    lr_min = lr.amin(dim=0)
    lr_max = lr.amax(dim=0)

    def lift(a):
        return repeat_interleave_2d(a, lowres_scale)

    return Standardization(
        lr_mean=lr_mean, lr_std=lr_std,
        hr_mean=lift(lr_mean), hr_std=lift(lr_std),
        lr_min=lr_min, lr_max=lr_max,
        hr_min=lift(lr_min), hr_max=lift(lr_max),
    )


def standardize(x, mean, std, mn, mx, mode: str, epsilon: float) -> torch.Tensor:
    """One of the four standardization modes: perpixel, none, pertimestep
    (each sample's own spatial mean/std, ddof=0), minmax."""
    if mode == "none":
        return x
    if mode == "perpixel":
        return (x - mean) / (std + epsilon)
    if mode == "pertimestep":
        m = x.mean(dim=(1, 2), keepdim=True)
        s = x.std(dim=(1, 2), keepdim=True, correction=0)
        return (x - m) / (s + epsilon)
    if mode == "minmax":
        return (x - mn) / (mx - mn + epsilon)
    raise ValueError(f"unknown standardization {mode!r}")


def preprocess_batch(
    hr: torch.Tensor,
    stats: Standardization,
    pipeline: str,
    lowres_scale: int,
    interp_mode: str = "nearest",
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
) -> dict[str, torch.Tensor]:
    """Raw HR batch (B, H, W, C) -> model inputs/targets + diagnostics, for
    the four pipelines of ``probunet_tpu.data.climex.preprocess_batch``."""
    if pipeline not in PIPELINE_TYPES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    k = lowres_scale
    lr = avg_pool(hr, k)

    def st(x, mean, std, mn, mx):
        return standardize(x, mean, std, mn, mx, standardization, epsilon)

    lr_stand = st(lr, stats.lr_mean, stats.lr_std, stats.lr_min, stats.lr_max)

    out = {"hr": hr, "lr": lr}
    item_stats = None
    if standardization == "pertimestep":
        # one set of per-item stats (the HR field's) standardizes both the
        # target and the lrinterp baseline, so residuals invert exactly
        item_stats = {
            "mean": hr.mean(dim=(1, 2), keepdim=True),
            "std": hr.std(dim=(1, 2), keepdim=True, correction=0),
        }
        out["stand_stats"] = item_stats
        hr_stand = (hr - item_stats["mean"]) / (item_stats["std"] + epsilon)
    else:
        hr_stand = st(hr, stats.hr_mean, stats.hr_std, stats.hr_min, stats.hr_max)

    if pipeline == "lr_to_hr":
        return {"inputs": lr_stand, "targets": hr_stand, **out}

    lrinterp = upsample(lr, k, interp_mode)
    out["lrinterp"] = lrinterp
    if pipeline == "lr_to_residuals":
        residual = hr_stand - upsample(lr_stand, k, interp_mode)
        return {"inputs": lr_stand, "targets": residual, **out}

    if standardization == "pertimestep":
        lrinterp_stand = (lrinterp - item_stats["mean"]) / (item_stats["std"] + epsilon)
    else:
        lrinterp_stand = st(lrinterp, stats.hr_mean, stats.hr_std,
                            stats.hr_min, stats.hr_max)
    if pipeline == "lrinterp_to_residuals":
        return {"inputs": lrinterp_stand, "targets": hr_stand - lrinterp_stand, **out}
    return {"inputs": lrinterp_stand, "targets": hr_stand, **out}


def lrinterp_from_batch(batch: dict[str, torch.Tensor], lowres_scale: int,
                        interp_mode: str = "nearest") -> torch.Tensor:
    """The interpolated-LR baseline field for any pipeline's batch dict."""
    if "lrinterp" in batch:
        return batch["lrinterp"]
    return upsample(batch["lr"], lowres_scale, interp_mode)


def invstand_residual(
    residual: torch.Tensor,
    stats: Standardization,
    pipeline: str,
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
    item_stats: dict | None = None,
) -> torch.Tensor:
    """Invert the standardization of a model output; ``item_stats`` is the
    ``stand_stats`` dict of :func:`preprocess_batch` (pertimestep only)."""
    to_hr = pipeline in ("lr_to_hr", "lrinterp_to_hr")
    if standardization == "none":
        return residual
    if standardization == "perpixel":
        scaled = residual * (stats.hr_std + epsilon)
        return scaled + stats.hr_mean if to_hr else scaled
    if standardization == "minmax":
        scaled = residual * (stats.hr_max - stats.hr_min + epsilon)
        return scaled + stats.hr_min if to_hr else scaled
    if standardization == "pertimestep":
        if item_stats is None:
            raise ValueError("pertimestep inversion needs item_stats")
        scaled = residual * (item_stats["std"] + epsilon)
        return scaled + item_stats["mean"] if to_hr else scaled
    raise ValueError(f"unknown standardization {standardization!r}")


def residual_to_hr(
    residual: torch.Tensor,
    lrinterp: torch.Tensor,
    stats: Standardization,
    pipeline: str = "lrinterp_to_residuals",
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
    item_stats: dict | None = None,
) -> torch.Tensor:
    """Model output (standardized) -> HR field in storage units: lrinterp +
    unstandardized residual, or the unstandardized field itself for the
    ``*_to_hr`` pipelines."""
    inv = invstand_residual(residual, stats, pipeline, epsilon,
                            standardization, item_stats)
    if pipeline in ("lr_to_hr", "lrinterp_to_hr"):
        return inv
    return lrinterp + inv
