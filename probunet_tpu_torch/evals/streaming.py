"""Streaming (constant-host-memory) ensemble evaluation (port of
``probunet_tpu/evals/streaming.py``).

Every metric the evaluate path reports is reduced on the device per batch;
only O(B*C + k*C) partial rows reach the host: per-item empirical CRPS,
MAE of the ensemble mean and ensemble spread; per-batch PSD sums of the
ground truth and the ensemble mean; running per-variable min/max, which
fix the shared bins of an exact second histogram pass.
"""

from __future__ import annotations

import numpy as np
import torch

from probunet_tpu_torch.evals.psd import psd
from probunet_tpu_torch.ops.losses import crps_empirical


def _batch_partials(ens: torch.Tensor, gt: torch.Tensor) -> dict[str, torch.Tensor]:
    """ens (B, M, H, W, C), gt (B, H, W, C) -> small per-item / per-batch
    reductions."""
    crps_pt = crps_empirical(ens.movedim(1, 0), gt).mean(dim=(1, 2))
    emean = ens.mean(dim=1)
    mae_pt = torch.abs(emean - gt).mean(dim=(1, 2))
    spread_pt = ens.std(dim=1, correction=1).mean(dim=(1, 2))
    return {
        "crps_pt": crps_pt,
        "mae_pt": mae_pt,
        "spread_pt": spread_pt,
        "psd_gt_sum": psd(gt).sum(dim=0),
        "psd_model_sum": psd(emean).sum(dim=0),
        "gt_min": gt.amin(dim=tuple(range(gt.dim() - 1))),
        "gt_max": gt.amax(dim=tuple(range(gt.dim() - 1))),
        "ens_min": ens.amin(dim=tuple(range(ens.dim() - 1))),
        "ens_max": ens.amax(dim=tuple(range(ens.dim() - 1))),
    }


def _batch_hist(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                bins: int) -> torch.Tensor:
    """(C, bins) counts of the pooled pixels of values (..., C) on uniform
    buckets over [lo, hi] per variable (right-closed last bucket, values
    outside dropped) — additive across batches."""
    c = values.shape[-1]
    v = values.reshape(-1, c)
    width = (hi - lo) / bins
    idx = torch.floor((v - lo[None, :]) / width[None, :]).to(torch.int64)
    idx = torch.where(v == hi[None, :], bins - 1, idx)
    valid = (idx >= 0) & (idx < bins)
    flat = idx.clamp(0, bins - 1) + bins * torch.arange(c, device=v.device)[None, :]
    return torch.bincount(flat[valid], minlength=c * bins).reshape(c, bins)


class EvalAccumulator:
    """Accumulates per-batch device partials; never holds fields on host::

        acc = EvalAccumulator()
        for batch:   acc.update(ens, gt)         # pass 1 (metrics + ranges)
        for batch:   acc.update_hist(ens, gt)    # optional pass 2 (figures)
        out = acc.result()
    """

    def __init__(self, hist_bins: int = 100):
        self.hist_bins = hist_bins
        self._rows: list[dict[str, np.ndarray]] = []
        self._psd_gt = None
        self._psd_model = None
        self._n_items = 0
        self._lo = None
        self._hi = None
        self._hist_gt = None
        self._hist_model = None

    def update(self, ens: torch.Tensor, gt: torch.Tensor) -> None:
        p = {k: v.cpu().numpy() for k, v in _batch_partials(ens, gt).items()}
        self._rows.append({k: p[k] for k in ("crps_pt", "mae_pt", "spread_pt")})
        self._n_items += int(p["crps_pt"].shape[0])
        lo = np.minimum(p["gt_min"], p["ens_min"])
        hi = np.maximum(p["gt_max"], p["ens_max"])
        if self._psd_gt is None:
            self._psd_gt = p["psd_gt_sum"].astype(np.float64)
            self._psd_model = p["psd_model_sum"].astype(np.float64)
            self._lo, self._hi = lo, hi
        else:
            self._psd_gt += p["psd_gt_sum"]
            self._psd_model += p["psd_model_sum"]
            self._lo = np.minimum(self._lo, lo)
            self._hi = np.maximum(self._hi, hi)

    def hist_range(self) -> tuple[np.ndarray, np.ndarray]:
        """(lo, hi) per variable — the shared binning of GT and model fields."""
        return np.asarray(self._lo), np.asarray(self._hi)

    def update_hist(self, ens: torch.Tensor, gt: torch.Tensor) -> None:
        """Second-pass histogram accumulation on the pass-1 global range."""
        lo = torch.as_tensor(self._lo, dtype=torch.float32, device=gt.device)
        hi = torch.as_tensor(self._hi, dtype=torch.float32, device=gt.device)
        hg = _batch_hist(gt.float(), lo, hi, self.hist_bins).cpu().numpy().astype(np.float64)
        hm = _batch_hist(ens.float(), lo, hi, self.hist_bins).cpu().numpy().astype(np.float64)
        if self._hist_gt is None:
            self._hist_gt, self._hist_model = hg, hm
        else:
            self._hist_gt += hg
            self._hist_model += hm

    def result(self) -> dict:
        """The final tables: per-timestep CRPS/MAE with mean/std, spread,
        dataset-mean PSDs, and the histograms if pass 2 ran."""
        crps = np.concatenate([r["crps_pt"] for r in self._rows])   # (T, C)
        mae = np.concatenate([r["mae_pt"] for r in self._rows])
        spread = np.concatenate([r["spread_pt"] for r in self._rows])
        t = self._n_items
        out = {
            "items": t,
            "crps": {"mean": crps.mean(axis=0), "std": crps.std(axis=0),
                     "per_timestep": crps},
            "mae": {"mean": mae.mean(axis=0), "std": mae.std(axis=0),
                    "per_timestep": mae},
            "spread": spread.mean(axis=0),
            "psd_gt": self._psd_gt / t,
            "psd_model": self._psd_model / t,
        }
        if self._hist_gt is not None:
            lo, hi = self.hist_range()
            edges = lo[:, None] + (hi - lo)[:, None] * np.linspace(
                0.0, 1.0, self.hist_bins + 1)[None, :]        # (C, bins+1)
            centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
            with np.errstate(divide="ignore"):
                log_gt = np.where(self._hist_gt > 0, np.log10(self._hist_gt), np.nan)
                log_model = np.where(self._hist_model > 0,
                                     np.log10(self._hist_model), np.nan)
            out["hist"] = {"centers": centers, "lo": lo, "hi": hi,
                           "gt_counts": self._hist_gt,
                           "model_counts": self._hist_model,
                           "gt_log": log_gt, "model_log": log_model}
        return out
