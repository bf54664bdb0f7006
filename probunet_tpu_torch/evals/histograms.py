"""Distribution-fidelity histograms (port of
``probunet_tpu/evals/histograms.py``): pooled pixel-value histograms of
ground truth vs model ensembles on a common binning, log-scaled counts.

:func:`log_histogram` counts on the values' device with ``jnp.histogram``'s
rules: edges ``linspace(lo, hi, bins + 1)`` in the values' float type,
each bucket closed on the left, the last also on the right, values outside
``[lo, hi]`` dropped.
"""

from __future__ import annotations

import numpy as np
import torch


def _edges(lo: float, hi: float, bins: int, dtype, device) -> torch.Tensor:
    """``jnp.histogram_bin_edges``: the range in the values' type (widened
    by 0.5 each way when empty), then ``jnp.linspace``'s
    lo * (1 - s) + hi * s with s = i / bins, the last edge hi itself."""
    lo_t = torch.tensor(lo, dtype=dtype, device=device)
    hi_t = torch.tensor(hi, dtype=dtype, device=device)
    if bool(lo_t == hi_t):
        lo_t, hi_t = lo_t - 0.5, hi_t + 0.5
    step = torch.arange(bins, dtype=dtype, device=device) / bins
    return torch.cat([lo_t * (1 - step) + hi_t * step, hi_t[None]])


def log_histogram(
    values,
    bins: int = 100,
    value_range: tuple[float, float] | None = None,
    density: bool = False,
):
    """Histogram of pooled pixel values with log10 counts.

    values: array of any shape (flattened). Returns (bin_centers, counts,
    log10_counts) as numpy; zero-count bins get nan in place of -inf.
    """
    v = torch.as_tensor(values).reshape(-1).contiguous()
    if not v.is_floating_point():
        v = v.float()
    if value_range is None:
        value_range = (float(v.min()), float(v.max()))
    edges = _edges(*value_range, bins, v.dtype, v.device)
    idx = torch.searchsorted(edges, v, right=True)
    idx = torch.where(v == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1: bins + 1].to(v.dtype)
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    centers = 0.5 * (edges[:-1] + edges[1:])
    counts_np = counts.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        log_counts = np.where(counts_np > 0, np.log10(counts_np), np.nan)
    return centers.cpu().numpy(), counts_np, log_counts


def compare_histograms(
    groundtruth,
    model_fields: dict,
    bins: int = 100,
    per_variable: bool = True,
    variables=("pr", "tasmin", "tasmax"),
):
    """GT-vs-models pooled histograms on shared bins, per variable.

    groundtruth: (T, H, W, C); model_fields: {name: (T, [M,] H, W, C)}.
    Returns {var: {"bins": centers, "gt": log_counts, name: log_counts...}}.
    """
    gt = np.asarray(groundtruth)
    out = {}
    for ci, var in enumerate(variables[: gt.shape[-1]]):
        gv = gt[..., ci].reshape(-1)
        lo, hi = float(gv.min()), float(gv.max())
        for f in model_fields.values():
            fv = np.asarray(f)[..., ci]
            lo, hi = min(lo, float(fv.min())), max(hi, float(fv.max()))
        centers, _, gt_log = log_histogram(gv, bins, (lo, hi))
        entry = {"bins": centers, "gt": gt_log}
        for name, f in model_fields.items():
            _, _, m_log = log_histogram(
                np.asarray(f)[..., ci].reshape(-1), bins, (lo, hi)
            )
            entry[name] = m_log
        out[var] = entry
    return out
