"""WMSE weight-function analysis (port of ``probunet_tpu/evals/weights.py``):
the weight w(y) = min(alpha * e^{beta * y}, 1) of the WMSE + MS-SSIM loss
over the distribution of standardized targets, per variable, to choose
(alpha, beta) so that extreme targets get full weight while the bulk is
down-weighted. Host-side numpy; the weights are computed in f32 by
``ops.losses.wmse_weights``.
"""

from __future__ import annotations

import numpy as np
import torch

from probunet_tpu_torch.ops.losses import wmse_weights


def _weights(y: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    return wmse_weights(torch.as_tensor(np.asarray(y), dtype=torch.float32),
                        alpha=alpha, beta=beta).numpy()


def weight_function_analysis(targets: np.ndarray, alpha: float = 0.007, beta: float = 0.048,
                             bins: int = 80, variables=("pr", "tasmin", "tasmax")) -> dict:
    """Distribution of w(y) over (T, H, W, C) standardized targets, per
    variable: the target histogram, the weight curve over its bins, the
    mean weight and the saturated fraction (w == 1)."""
    t = np.asarray(targets)
    out = {}
    for ci, var in enumerate(variables[: t.shape[-1]]):
        y = t[..., ci].reshape(-1)
        w = _weights(y, alpha, beta)
        counts, edges = np.histogram(y, bins=bins)
        centers = 0.5 * (edges[:-1] + edges[1:])
        out[var] = {
            "target_bins": centers,
            "target_counts": counts,
            "weight_curve": _weights(centers, alpha, beta),
            "mean_weight": float(w.mean()),
            "saturated_fraction": float((w >= 1.0 - 1e-12).mean()),
            "alpha": alpha,
            "beta": beta,
        }
    return out


def plot_weight_function(analysis: dict, save_path: str | None = None):
    """Target histogram (log counts) and weight curve per variable;
    matplotlib is imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nvar = len(analysis)
    fig, axes = plt.subplots(1, nvar, figsize=(4.5 * nvar, 3.5), squeeze=False)
    for ax, (var, a) in zip(axes[0], analysis.items()):
        ax.bar(a["target_bins"], a["target_counts"],
               width=np.diff(a["target_bins"]).mean(), alpha=0.4, label="targets")
        ax.set_yscale("log")
        ax2 = ax.twinx()
        ax2.plot(a["target_bins"], a["weight_curve"], "C1",
                 label=f"w(y), sat={a['saturated_fraction']:.2%}")
        ax2.set_ylim(0, 1.05)
        ax.set_title(f"{var} (mean w={a['mean_weight']:.3f})")
        ax.set_xlabel("standardized target")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=110)
        plt.close(fig)
    return fig
