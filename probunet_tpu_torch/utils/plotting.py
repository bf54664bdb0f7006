"""Evaluation figures (port of the serve-path figures of
``probunet_tpu/utils/plotting.py``): the GT-vs-model PSD, the pooled
pixel-value log-histograms and the return-level curves.

matplotlib is imported when a figure is drawn, not with the module: a
host without it still imports every module of the port, and the commands
that draw figures report them skipped.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, save_path):
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=110)
        _pyplot().close(fig)
    return fig


def plot_psd(
    psd_dict: dict,
    variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
    save_path: str | None = None,
):
    """GT-vs-model radially-averaged PSD + ratio panels (results.ipynb
    cells 8-10). psd_dict: {"gt": (k, C), name: (k, C), ...}."""
    plt = _pyplot()
    gt = np.asarray(psd_dict["gt"])
    nvar = gt.shape[-1]
    fig, axes = plt.subplots(2, nvar, figsize=(4 * nvar, 7), squeeze=False)
    k = np.arange(1, gt.shape[0])
    for ci in range(nvar):
        var = variables[ci] if ci < len(variables) else f"var{ci}"
        for name, spec in psd_dict.items():
            spec = np.asarray(spec)
            axes[0, ci].loglog(k, spec[1:, ci], label=name,
                               lw=2 if name == "gt" else 1)
            if name != "gt":
                axes[1, ci].semilogx(k, spec[1:, ci] / gt[1:, ci], label=name)
        axes[1, ci].axhline(1.0, color="k", lw=0.5)
        axes[0, ci].set_title(var)
        axes[0, ci].legend(fontsize=7)
        axes[1, ci].set_xlabel("wavenumber")
        axes[1, ci].set_ylabel("model/GT power")
    axes[0, 0].set_ylabel("power")
    fig.tight_layout()
    return _save(fig, save_path)


def plot_histograms(
    hist_dict: dict,
    save_path: str | None = None,
):
    """Pooled pixel-value log-frequency histograms, GT vs model variants
    (results.ipynb cell 15). ``hist_dict`` is
    :func:`probunet_tpu_torch.evals.histograms.compare_histograms` output:
    {var: {"bins": centers, "gt": log_counts, name: log_counts, ...}}."""
    plt = _pyplot()
    variables = list(hist_dict)
    fig, axes = plt.subplots(1, len(variables),
                             figsize=(4.5 * len(variables), 4), squeeze=False)
    for ci, var in enumerate(variables):
        entry = hist_dict[var]
        bins = np.asarray(entry["bins"])
        ax = axes[0, ci]
        for name, logc in entry.items():
            if name == "bins":
                continue
            ax.plot(bins, np.asarray(logc), label=name,
                    lw=2 if name == "gt" else 1)
        ax.set_title(var)
        ax.set_xlabel("value")
        ax.legend(fontsize=7)
    axes[0, 0].set_ylabel("log10 frequency")
    fig.tight_layout()
    return _save(fig, save_path)


def plot_return_levels(
    analysis,
    observed_analysis: dict | None = None,
    label: str = "model",
    save_path: str | None = None,
):
    """Return-level curves with bootstrap CI + empirical points
    (test_return_levels.ipynb / compare_observed_vs_model_return_levels
    .ipynb cells 7-21). ``analysis`` is one
    :func:`probunet_tpu_torch.evals.gev.return_level_analysis` output, or a
    list of (analysis, label) pairs / a {label: analysis} dict, each model
    on the same axes in its own color."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))

    def draw(a, name, color):
        t = a["return_periods"]
        ax.semilogx(t, a["return_levels"], color=color, label=f"{name} GEV fit")
        ax.fill_between(t, a["bootstrap"]["lower"], a["bootstrap"]["upper"],
                        color=color, alpha=0.2, label=f"{name} 95% CI")
        ax.semilogx(a["empirical_return_periods"], a["empirical_levels"],
                    "o", ms=3, color=color, label=f"{name} empirical")

    if isinstance(analysis, dict) and "return_periods" in analysis:
        entries = [(analysis, label)]
    elif isinstance(analysis, dict):
        entries = list((a, name) for name, a in analysis.items())
    else:  # sequence of analyses or (analysis, label) pairs
        entries = []
        for i, e in enumerate(analysis):
            if isinstance(e, dict):
                entries.append((e, f"model {i + 1}"))
            else:
                entries.append((e[0], e[1]))
    for i, (a, name) in enumerate(entries):
        draw(a, name, f"C{i % 9}")
    if observed_analysis is not None:
        draw(observed_analysis, "observed", "k")
    ax.set_xlabel("return period [years]")
    ax.set_ylabel("return level")
    ax.legend(fontsize=7)
    fig.tight_layout()
    return _save(fig, save_path)
