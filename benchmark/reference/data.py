"""Plain float32 data path of the reference: the physical transform and its
inverse, the per-pixel statistics of the split, the preprocessing of the
``lrinterp_to_residuals`` pipeline (pooling, per-pixel standardization,
nearest upsampling), the way back to physical fields, and the metrics
the evaluation reports per item (ensemble CRPS, MAE of the ensemble mean,
ensemble spread).
"""

from __future__ import annotations

import torch

SOFTPLUS_THRESHOLD = 20.0


def softplus_inv(x: torch.Tensor, c: float = 1e-7) -> torch.Tensor:
    safe = torch.where(x > SOFTPLUS_THRESHOLD, torch.ones_like(x), x)
    return torch.where(x > SOFTPLUS_THRESHOLD, x, torch.log(torch.expm1(safe + c)))


def softplus(x: torch.Tensor, c: float = 1e-7) -> torch.Tensor:
    safe = torch.where(x > SOFTPLUS_THRESHOLD, torch.zeros_like(x), x)
    return torch.where(x > SOFTPLUS_THRESHOLD, x, torch.log1p(torch.exp(safe)) - c)


def to_storage(raw: torch.Tensor, variables) -> torch.Tensor:
    """Physical fields (..., C) -> storage space: pr through the inverse
    softplus, tasmax as the inverse softplus of tasmax - tasmin."""
    v = list(variables)
    out = []
    for i, name in enumerate(v):
        x = raw[..., i]
        if name == "pr":
            x = softplus_inv(x)
        elif name == "tasmax" and "tasmin" in v:
            x = softplus_inv(raw[..., i] - raw[..., v.index("tasmin")], c=0.0)
        out.append(x)
    return torch.stack(out, dim=-1)


def to_physical(x: torch.Tensor, variables) -> torch.Tensor:
    v = list(variables)
    out = []
    for i, name in enumerate(v):
        if name == "pr":
            out.append(softplus(x[..., i]))
        elif name == "tasmax" and "tasmin" in v:
            out.append(x[..., v.index("tasmin")] + softplus(x[..., i], c=0.0))
        else:
            out.append(x[..., i])
    return torch.stack(out, dim=-1)


def pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window means of (B, H, W, C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))


def upsample(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.repeat_interleave(k, dim=-3).repeat_interleave(k, dim=-2)


def split_stats(raw_days, variables, k: int, device, chunk: int = 365) -> dict:
    """Per-pixel time mean and std (ddof 1) of the pooled storage-space
    split, lifted to the HR grid; accumulated in float64 over chunks of
    days of the host array ``raw_days`` (T, H, W, C)."""
    s1 = s2 = None
    n = raw_days.shape[0]
    for a in range(0, n, chunk):
        lr = pool(to_storage(torch.from_numpy(raw_days[a:a + chunk]).to(device), variables),
                  k).double()
        s1 = lr.sum(dim=0) if s1 is None else s1 + lr.sum(dim=0)
        s2 = (lr * lr).sum(dim=0) if s2 is None else s2 + (lr * lr).sum(dim=0)
    mean = s1 / n
    std = torch.sqrt(torch.clamp((s2 - n * mean * mean) / (n - 1), min=0.0))
    return {"hr_mean": upsample(mean.float(), k), "hr_std": upsample(std.float(), k)}


def preprocess(raw: torch.Tensor, stats: dict, variables, k: int, epsilon: float) -> dict:
    """Physical (B, H, W, C) -> model input (standardized lrinterp), target
    (standardized residual), lrinterp and the storage-space field."""
    hr = to_storage(raw, variables)
    lrinterp = upsample(pool(hr, k), k)
    mean, std = stats["hr_mean"], stats["hr_std"]
    hr_st = (hr - mean) / (std + epsilon)
    li_st = (lrinterp - mean) / (std + epsilon)
    return {"inputs": li_st, "targets": hr_st - li_st, "lrinterp": lrinterp, "hr": hr}


def to_hr(residual: torch.Tensor, lrinterp: torch.Tensor, stats: dict, epsilon: float):
    """Standardized residual (B, M, H, W, C) -> storage-space field."""
    return lrinterp[:, None] + residual * (stats["hr_std"] + epsilon)


def crps_items(ens: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Ensemble CRPS of ens (B, M, H, W, C) against gt (B, H, W, C), the
    mean over the pixels of each item: E|x - y| - E|x - x'| / 2 over ordered
    member pairs (B, C), from the sorted members."""
    m = ens.shape[1]
    srt = torch.sort(ens, dim=1).values
    w = (2.0 * torch.arange(m, device=ens.device) - (m - 1)).reshape(1, m, 1, 1, 1)
    spread = (srt * w).sum(dim=1) * 2.0 / (m * m)
    return (torch.abs(ens - gt[:, None]).mean(dim=1) - 0.5 * spread).mean(dim=(1, 2))


def eval_items(ens: torch.Tensor, gt: torch.Tensor) -> dict:
    """Per item and variable (B, C): CRPS, MAE of the ensemble mean and the
    members' standard deviation (ddof 1), each a mean over the pixels."""
    return {"crps": crps_items(ens, gt),
            "mae": torch.abs(ens.mean(dim=1) - gt).mean(dim=(1, 2)),
            "spread": ens.std(dim=1, correction=1).mean(dim=(1, 2))}
