"""Figures (port of ``probunet_tpu/utils/plotting.py``): the LR /
prediction / HR / error grid of a batch, the training
loop's ensemble, residual and member-difference grids and loss curves,
the evaluation's GT-vs-model PSD, pooled pixel-value log-histograms
and return-level curves, ``explore``'s latent grids and PC1 x PC2
joint-marginal histogram, and the EDA's seasonal maps.

matplotlib (and cartopy, for the ClimEx RotatedPole map panels, when it
is importable) is imported when a figure is drawn, not with the module: a
host without it still imports every module of the port, and the commands
that draw figures report them skipped. Inputs are NHWC numpy arrays.
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


_CMAPS = {"pr": "Blues", "tasmin": "coolwarm", "tasmax": "coolwarm"}
_UNITS = {"pr": "mm/day", "tasmin": "°C", "tasmax": "°C"}


def _cartopy():
    """(cartopy.crs, the ClimEx RotatedPole CRS), or (None, None) when
    cartopy is missing or broken: panels then fall back to plain axes."""
    try:
        import cartopy.crs as ccrs
        return ccrs, ccrs.RotatedPole(pole_longitude=83.0, pole_latitude=42.5)
    except Exception:
        return None, None


def _subplots(nrows, ncols, scale=2.4):
    plt = _pyplot()
    _, crs = _cartopy()
    kw = {"subplot_kw": {"projection": crs}} if crs is not None else {}
    return plt.subplots(nrows, ncols, figsize=(scale * ncols, scale * nrows),
                        squeeze=False, **kw)


def _imshow(ax, field, cmap, vmin=None, vmax=None, lat=None, lon=None, labels=None):
    """One map panel: geo-referenced ``pcolormesh(lon, lat, ...)`` with
    ``lat``/``lon`` (2-D or 1-D coordinates of the NetCDF ingest, block-
    averaged to a coarser field's grid), with the reference's dashed
    lat/lon gridlines when ``labels`` is ``"left"`` or ``"bottom"``;
    index-space ``imshow`` without coordinates or when they do not fit."""
    ccrs, _ = _cartopy()
    field = np.asarray(field)
    coords = None
    if lat is not None and lon is not None:
        lat, lon = np.asarray(lat), np.asarray(lon)
        if lat.ndim == 1 and lon.ndim == 1:
            lon, lat = np.meshgrid(lon, lat)
        try:
            coords = _coarsen_coords(lat, lon, field.shape)
        except (ValueError, IndexError):
            coords = None
    if coords is not None:
        lat, lon = coords
        kw = {"transform": ccrs.PlateCarree()} if ccrs is not None else {}
        im = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax, **kw)
        if ccrs is not None:
            ax.coastlines(linewidth=0.4)
        if labels is not None:
            _gridline_furniture(ax, lat, lon, labels)
            return im
    else:
        im = ax.imshow(field, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
    ax.set_xticks([])
    ax.set_yticks([])
    return im


def _gridline_furniture(ax, lat, lon, labels):
    """Dashed labeled lat/lon gridlines, top and right labels off, left
    labels only where ``labels == "left"``."""
    ccrs, _ = _cartopy()
    if ccrs is not None:
        gl = ax.gridlines(crs=ccrs.PlateCarree(), draw_labels=True, x_inline=False,
                          y_inline=False, linestyle="--", linewidth=0.3)
        gl.top_labels = False
        gl.right_labels = False
        gl.left_labels = labels == "left"
        gl.xlabel_style = {"size": 6}
        gl.ylabel_style = {"size": 6}
        return
    ax.grid(linestyle="--", linewidth=0.3)
    xt = np.linspace(lon.min(), lon.max(), 5)[1:-1]
    ax.set_xticks(xt)
    ax.set_xticklabels([f"{v:.1f}°" for v in xt], fontsize=6)
    if labels == "left":
        yt = np.linspace(lat.min(), lat.max(), 5)[1:-1]
        ax.set_yticks(yt)
        ax.set_yticklabels([f"{v:.1f}°" for v in yt], fontsize=6)
    else:
        ax.set_yticks([])


def _coords_at(lat, lon, i):
    """Item ``i``'s coordinates from (B, H, W) stacks; static ones as they are."""
    if lat is None or lon is None:
        return lat, lon
    lat, lon = np.asarray(lat), np.asarray(lon)
    if lat.ndim == 3:
        lat = lat[min(i, lat.shape[0] - 1)]
    if lon.ndim == 3:
        lon = lon[min(i, lon.shape[0] - 1)]
    return lat, lon


def _coarsen_coords(lat, lon, field_shape):
    """HR lat/lon block-averaged down to a coarser field's grid."""
    fh, fw = field_shape[-2], field_shape[-1]
    if lat.ndim != 2 or lon.ndim != 2:
        raise ValueError(f"lat/lon must be 2-D grids, got {lat.shape}")
    if lat.shape == (fh, fw):
        return lat, lon
    kh, kw = lat.shape[0] // fh, lat.shape[1] // fw
    if kh < 1 or kw < 1 or lat.shape != (fh * kh, fw * kw):
        raise ValueError(f"lat/lon shape {lat.shape} incompatible with field {field_shape}")

    def pool(a):
        return a.reshape(fh, kh, fw, kw).mean(axis=(1, 3))

    return pool(lat), pool(lon)


def plot_batch(lr, pred, hr, variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
               timestamps=None, max_items: int = 4, save_path: str | None = None,
               lat=None, lon=None):
    """LR / prediction / HR / |error| grid per variable (reference
    src/climex_utils.py:288-439), one figure per variable (``save_path``
    gets ``_<var>`` before ``.png``). Inputs are (B, h, w, C) / (B, H, W, C)
    NHWC arrays in physical units; ``lat``/``lon`` geo-reference the
    panels."""
    lr, pred, hr = map(np.asarray, (lr, pred, hr))
    b = min(max_items, pred.shape[0])
    figs = {}
    for ci, var in enumerate(variables[: pred.shape[-1]]):
        fig, axes = _subplots(4, b)
        vmin = min(hr[:b, ..., ci].min(), pred[:b, ..., ci].min())
        vmax = max(hr[:b, ..., ci].max(), pred[:b, ..., ci].max())
        cmap = _CMAPS.get(var, "viridis")
        for i in range(b):
            la, lo = _coords_at(lat, lon, i)
            lab = "left" if i == 0 else "bottom"
            _imshow(axes[0, i], lr[i, ..., ci], cmap, vmin, vmax, la, lo, lab)
            _imshow(axes[1, i], pred[i, ..., ci], cmap, vmin, vmax, la, lo, lab)
            im = _imshow(axes[2, i], hr[i, ..., ci], cmap, vmin, vmax, la, lo, lab)
            err = np.abs(pred[i, ..., ci] - hr[i, ..., ci])
            im_e = _imshow(axes[3, i], err, "Reds", lat=la, lon=lo, labels=lab)
            if timestamps is not None:
                axes[0, i].set_title(str(timestamps[i]), fontsize=7)
        for row, lab in enumerate(["LR", "pred", "HR", "|err|"]):
            axes[row, 0].set_ylabel(lab)
        fig.colorbar(im, ax=axes[:3, :], shrink=0.6, label=f"{var} [{_UNITS.get(var, '')}]")
        fig.colorbar(im_e, ax=axes[3, :], shrink=0.8)
        fig.suptitle(var)
        figs[var] = _save(fig, save_path and save_path.replace(".png", f"_{var}.png"))
    return figs


def plot_sample_batch(samples, hr, lrinterp=None,
                      variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
                      max_items: int = 3, save_path: str | None = None, lat=None, lon=None):
    """Ensemble-member grid per variable: rows = items, columns =
    [lrinterp?, HR, member_1..member_M]. samples: (B, M, H, W, C)."""
    samples, hr = np.asarray(samples), np.asarray(hr)
    b, m = min(max_items, samples.shape[0]), samples.shape[1]
    figs = {}
    for ci, var in enumerate(variables[: samples.shape[-1]]):
        fig, axes = _subplots(b, m + (1 if lrinterp is None else 2))
        cmap = _CMAPS.get(var, "viridis")
        for i in range(b):
            vmin = min(hr[i, ..., ci].min(), samples[i, ..., ci].min())
            vmax = max(hr[i, ..., ci].max(), samples[i, ..., ci].max())
            la, lo = _coords_at(lat, lon, i)
            col = 0
            if lrinterp is not None:
                _imshow(axes[i, col], np.asarray(lrinterp)[i, ..., ci], cmap, vmin, vmax,
                        la, lo, "left")
                if i == 0:
                    axes[i, col].set_title("lrinterp", fontsize=8)
                col += 1
            _imshow(axes[i, col], hr[i, ..., ci], cmap, vmin, vmax, la, lo,
                    "left" if col == 0 else "bottom")
            if i == 0:
                axes[i, col].set_title("HR", fontsize=8)
            for j in range(m):
                im = _imshow(axes[i, col + 1 + j], samples[i, j, ..., ci], cmap, vmin, vmax,
                             la, lo, "bottom")
                if i == 0:
                    axes[i, col + 1 + j].set_title(f"member {j + 1}", fontsize=8)
        fig.colorbar(im, ax=axes, shrink=0.6, label=f"{var} [{_UNITS.get(var, '')}]")
        fig.suptitle(f"{var} — {m}-member ensemble")
        figs[var] = _save(fig, save_path and save_path.replace(".png", f"_{var}.png"))
    return figs


def plot_residual_sample_batch(residual_samples, residual_target,
                               variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
                               max_items: int = 3, save_path: str | None = None,
                               lat=None, lon=None):
    """Residual-space ensemble grid, a diverging colormap symmetric about 0."""
    s, t = np.asarray(residual_samples), np.asarray(residual_target)
    b, m = min(max_items, s.shape[0]), s.shape[1]
    figs = {}
    for ci, var in enumerate(variables[: s.shape[-1]]):
        fig, axes = _subplots(b, m + 1)
        for i in range(b):
            v = max(np.abs(t[i, ..., ci]).max(), np.abs(s[i, ..., ci]).max())
            la, lo = _coords_at(lat, lon, i)
            _imshow(axes[i, 0], t[i, ..., ci], "RdBu_r", -v, v, la, lo, "left")
            if i == 0:
                axes[i, 0].set_title("target residual", fontsize=8)
            for j in range(m):
                im = _imshow(axes[i, 1 + j], s[i, j, ..., ci], "RdBu_r", -v, v, la, lo,
                             "bottom")
                if i == 0:
                    axes[i, 1 + j].set_title(f"member {j + 1}", fontsize=8)
        fig.colorbar(im, ax=axes, shrink=0.6)
        fig.suptitle(f"{var} — residual ensemble")
        figs[var] = _save(fig, save_path and save_path.replace(".png", f"_{var}.png"))
    return figs


def plot_residual_differences(samples, variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
                              item: int = 0, save_path: str | None = None, lat=None,
                              lon=None):
    """(M, M) grid of member_i - member_j panels of one item."""
    s = np.asarray(samples)[item]  # (M, H, W, C)
    m = s.shape[0]
    figs = {}
    for ci, var in enumerate(variables[: s.shape[-1]]):
        fig, axes = _subplots(m, m, scale=1.8)
        diffs = s[:, None, ..., ci] - s[None, :, ..., ci]
        v = max(np.abs(diffs).max(), 1e-12)
        la, lo = _coords_at(lat, lon, item)
        for i in range(m):
            for j in range(m):
                im = _imshow(axes[i, j], diffs[i, j], "RdBu_r", -v, v, la, lo,
                             "left" if j == 0 else "bottom")
        fig.colorbar(im, ax=axes, shrink=0.6)
        fig.suptitle(f"{var} — pairwise member differences")
        figs[var] = _save(fig, save_path and save_path.replace(".png", f"_{var}.png"))
    return figs


def plot_loss_curves(history: dict, save_path: str | None = None):
    """Train/val reconstruction and KL curves over the epochs."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    epochs = np.arange(1, len(history.get("train_crps", [])) + 1)
    for ax, key, ylabel in ((axes[0], "crps", "reconstruction"), (axes[1], "kl", "KL(q||p)")):
        ax.plot(epochs, history.get(f"train_{key}", []), label="train")
        if history.get(f"val_{key}"):
            ax.plot(np.arange(1, len(history[f"val_{key}"]) + 1), history[f"val_{key}"],
                    label="val")
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
    axes[0].set_title("reconstruction loss")
    axes[1].set_yscale("log")
    axes[1].set_title("KL")
    for ax in axes:
        ax.legend()
    fig.tight_layout()
    return _save(fig, save_path)


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


def plot_latent_grid(
    decoded: np.ndarray,
    channel: int = 0,
    per_panel_norm: bool = False,
    symmetric: bool = True,
    cmap: str = "RdBu_r",
    title: str = "latent grid",
    save_path: str | None = None,
):
    """(n1, n2, H, W, C) decoded latent grid -> an n1 x n2 panel of one
    channel. ``symmetric`` (residual and delta fields) centers the scale
    on zero; otherwise (HR fields) the data range with a sequential cmap.
    ``per_panel_norm`` scales each panel to its own range."""
    d = np.asarray(decoded)[..., channel]
    n1, n2 = d.shape[:2]
    fig, axes = _subplots(n1, n2, scale=1.6)
    v = np.abs(d).max()
    glo, ghi = d.min(), d.max()
    for i in range(n1):
        for j in range(n2):
            if symmetric:
                vmax = (max(np.abs(d[i, j]).max(), 1e-12)
                        if per_panel_norm else v)
                vmin = -vmax
            elif per_panel_norm:
                vmin, vmax = d[i, j].min(), d[i, j].max()
            else:
                vmin, vmax = glo, ghi
            im = _imshow(axes[i, j], d[i, j], cmap, vmin, vmax)
    fig.colorbar(im, ax=axes, shrink=0.6)
    fig.suptitle(title)
    return _save(fig, save_path)


def plot_latent_joint_marginal(
    scores: np.ndarray,
    explained_variance_ratio=None,
    bins: int = 80,
    title_prefix: str = "Latent space (prior)",
    save_path: str | None = None,
):
    """PC1 x PC2 joint 2-D histogram with the marginal histograms.
    ``scores``: (N, >= 2) PCA scores; ``explained_variance_ratio``: the
    PCA's, for the title."""
    plt = _pyplot()
    s1, s2 = np.asarray(scores[:, 0]), np.asarray(scores[:, 1])
    fig = plt.figure(figsize=(7.5, 7.5))
    ax_joint = fig.add_axes([0.1, 0.1, 0.65, 0.65])
    ax_right = fig.add_axes([0.78, 0.1, 0.17, 0.65], sharey=ax_joint)
    ax_top = fig.add_axes([0.1, 0.78, 0.65, 0.17], sharex=ax_joint)

    h = ax_joint.hist2d(s1, s2, bins=bins, cmap="viridis")
    ax_joint.set_xlabel("PC1 score (s1)")
    ax_joint.set_ylabel("PC2 score (s2)")
    cb = fig.colorbar(h[3], ax=ax_joint, fraction=0.046, pad=0.04)
    cb.set_label("Counts")

    ax_top.hist(s1, bins=bins)
    ax_right.hist(s2, bins=bins, orientation="horizontal")
    plt.setp(ax_top.get_xticklabels(), visible=False)
    plt.setp(ax_right.get_yticklabels(), visible=False)
    ax_top.set_ylabel("Count")
    ax_right.set_xlabel("Count")

    if explained_variance_ratio is not None and len(explained_variance_ratio) >= 2:
        evr = np.asarray(explained_variance_ratio)
        fig.suptitle(
            f"{title_prefix} — PC1: {evr[0] * 100:.1f}%  |  "
            f"PC2: {evr[1] * 100:.1f}%", y=0.98,
        )
    else:
        fig.suptitle(title_prefix, y=0.98)
    return _save(fig, save_path)


def plot_seasonal_maps(seasonal: dict, var: str, stat: str = "mean", lat=None, lon=None,
                       title: str | None = None, save_path: str | None = None):
    """One row of season maps for one variable (reference
    src/baseline/climex_utils.py:647-696 ``plot_grids_seasonal``).

    ``seasonal``: :meth:`probunet_tpu_torch.data.eda.ClimexEDA.seasonal_stats`'
    {season: {stat: (H, W) map}}. pr on a sequential colormap from 0, the
    temperatures on a diverging one symmetric about 0, as the reference."""
    seasons = list(seasonal)
    fields = [np.asarray(seasonal[s][stat]) for s in seasons]
    stack = np.stack(fields)
    if var == "pr":
        cmap, vmin, vmax = _CMAPS.get("pr", "Blues"), 0.0, stack.max()
    else:
        m = np.abs(stack).max()
        cmap, vmin, vmax = "coolwarm", -m, m
    fig, axes = _subplots(1, len(seasons), scale=3.0)
    for j, (s, f) in enumerate(zip(seasons, fields)):
        im = _imshow(axes[0, j], f, cmap, vmin, vmax, lat, lon)
        axes[0, j].set_title(s, fontsize=12)
    fig.colorbar(im, ax=axes, shrink=0.8, label=f"{var} [{_UNITS.get(var, '')}]")
    fig.suptitle(title or f"{var} seasonal {stat}")
    return _save(fig, save_path)
