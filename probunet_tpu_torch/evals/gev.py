"""GEV extreme-value toolkit (a copy of ``probunet_tpu/evals/gev.py``,
numpy and scipy only, the same numbers for the same inputs and seed).

Re-implementation of the reference's extreme-value utilities
(reference src/prob_unet_utils.py:46-167) and the return-level analysis of
its notebooks (test_return_levels.ipynb, compare_observed_vs_model_return_
levels.ipynb). The fits are tiny (tens of annual maxima) and stay on the
host's scipy; the daily per-pixel ensembles they are fitted to come from
the batched ensemble inference upstream (the ``extremes`` command).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

try:
    from scipy.stats import genextreme
    HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    genextreme = None
    HAVE_SCIPY = False


def compute_annual_block_maxima(
    values: np.ndarray, days_per_year: int = 365
) -> np.ndarray:
    """Annual block maxima of a daily series
    (reference src/prob_unet_utils.py:46-70).

    values: (T,) or (T, ...) daily values; T need not be an exact multiple of
    days_per_year — the trailing partial year is dropped, matching the
    reference's per-year grouping. Returns (n_years, ...).
    """
    values = np.asarray(values)
    n_years = values.shape[0] // days_per_year
    if n_years == 0:
        raise ValueError(
            f"need >= {days_per_year} days, got {values.shape[0]}"
        )
    trimmed = values[: n_years * days_per_year]
    blocks = trimmed.reshape((n_years, days_per_year) + values.shape[1:])
    return blocks.max(axis=1)


class GEVFit(NamedTuple):
    shape: float   # scipy 'c' convention (c = -xi)
    loc: float
    scale: float


def gev_fit(block_maxima: np.ndarray) -> GEVFit:
    """Maximum-likelihood GEV fit of annual maxima (scipy ``genextreme.fit``,
    the same estimator the reference uses at src/prob_unet_utils.py:73-83)."""
    if not HAVE_SCIPY:
        raise ImportError("scipy is required for GEV fitting")
    c, loc, scale = genextreme.fit(np.asarray(block_maxima, dtype=np.float64))
    return GEVFit(float(c), float(loc), float(scale))


def gev_return_level(fit: GEVFit, return_periods) -> np.ndarray:
    """Return level(s) for return period(s) T years:
    ppf(1 - 1/T) of the fitted GEV (reference src/prob_unet_utils.py:73-83)."""
    if not HAVE_SCIPY:
        raise ImportError("scipy is required for GEV return levels")
    t = np.atleast_1d(np.asarray(return_periods, dtype=np.float64))
    levels = genextreme.ppf(1.0 - 1.0 / t, fit.shape, loc=fit.loc,
                            scale=fit.scale)
    return levels


def gev_parametric_bootstrap(
    fit: GEVFit,
    n_years: int,
    return_periods,
    n_boot: int = 1000,
    ci: float = 0.95,
    seed: int = 0,
) -> dict:
    """Parametric bootstrap CI on the return-level curve
    (reference src/prob_unet_utils.py:87-147): resample n_years maxima from
    the fitted GEV, refit, evaluate return levels; pointwise percentiles.

    Fits that fail (scipy raising) are skipped and counted, like the
    reference's validity bookkeeping (src/prob_unet_utils.py:128-137).
    """
    if not HAVE_SCIPY:
        raise ImportError("scipy is required for GEV bootstrap")
    rng = np.random.default_rng(seed)
    t = np.atleast_1d(np.asarray(return_periods, dtype=np.float64))
    curves = []
    n_failed = 0
    for _ in range(n_boot):
        sample = genextreme.rvs(
            fit.shape, loc=fit.loc, scale=fit.scale, size=n_years,
            random_state=rng,
        )
        try:
            bfit = gev_fit(sample)
            curve = gev_return_level(bfit, t)
            if not np.all(np.isfinite(curve)):
                raise ValueError("non-finite return levels")
            curves.append(curve)
        except Exception:
            n_failed += 1
    if not curves:
        raise RuntimeError("all bootstrap refits failed")
    curves = np.stack(curves)  # (n_valid, len(t))
    alpha = (1.0 - ci) / 2.0
    return {
        "lower": np.quantile(curves, alpha, axis=0),
        "upper": np.quantile(curves, 1.0 - alpha, axis=0),
        "median": np.quantile(curves, 0.5, axis=0),
        "n_valid": len(curves),
        "n_failed": n_failed,
    }


def get_empirical_return_periods(block_maxima: np.ndarray):
    """Empirical (plotting-position) return periods T_i = (N+1)/i for the
    sorted annual maxima (reference src/prob_unet_utils.py:150-167).

    Returns (return_periods, sorted_maxima_descending): the i-th largest
    maximum is exceeded on average once every (N+1)/i years.
    """
    bm = np.sort(np.asarray(block_maxima).reshape(-1))[::-1]
    n = bm.shape[0]
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return (n + 1) / ranks, bm


def model_ensemble_analysis(
    daily_ensemble: np.ndarray,
    return_periods=(2, 5, 10, 20, 50, 100),
    days_per_year: int = 365,
    n_boot: int = 1000,
    ci: float = 0.95,
    seed: int = 0,
) -> dict:
    """Return-level analysis of a MODEL ensemble's daily pixel series
    (the test_return_levels.ipynb cells 2-10 / compare_observed_vs_model_
    return_levels.ipynb cells 7-21 pipeline).

    daily_ensemble: (T, M) — M ensemble members' daily values at one pixel.
    Annual block maxima are taken per member and pooled (M members x
    n_years maxima = M independent realizations of each year's maximum),
    then GEV-fit with bootstrap CI. The pooled empirical maxima are what
    exposes the reference's known deficiency (model pr maxima plateau
    ~75 mm/day below the observed GEV curve,
    test_return_levels.ipynb cell 10).
    """
    arr = np.asarray(daily_ensemble)
    if arr.ndim != 2:
        raise ValueError(f"expected (T, M) ensemble, got {arr.shape}")
    bm = compute_annual_block_maxima(arr, days_per_year)  # (n_years, M)
    pooled = bm.reshape(-1)
    fit = gev_fit(pooled)
    levels = gev_return_level(fit, return_periods)
    boot = gev_parametric_bootstrap(
        fit, pooled.shape[0], return_periods, n_boot=n_boot, ci=ci, seed=seed
    )
    emp_t, emp_levels = get_empirical_return_periods(pooled)
    return {
        "fit": fit,
        "return_periods": np.asarray(return_periods, dtype=np.float64),
        "return_levels": levels,
        "bootstrap": boot,
        "empirical_return_periods": emp_t,
        "empirical_levels": emp_levels,
        "block_maxima": bm,
    }


def return_level_analysis(
    daily_series: np.ndarray,
    return_periods=(2, 5, 10, 20, 50, 100),
    days_per_year: int = 365,
    n_boot: int = 1000,
    ci: float = 0.95,
    seed: int = 0,
) -> dict:
    """End-to-end single-pixel analysis (the test_return_levels.ipynb cell-6
    pipeline): block maxima -> GEV fit -> return levels -> bootstrap CI ->
    empirical return periods."""
    bm = compute_annual_block_maxima(daily_series, days_per_year)
    fit = gev_fit(bm)
    levels = gev_return_level(fit, return_periods)
    boot = gev_parametric_bootstrap(
        fit, bm.shape[0], return_periods, n_boot=n_boot, ci=ci, seed=seed
    )
    emp_t, emp_levels = get_empirical_return_periods(bm)
    return {
        "fit": fit,
        "return_periods": np.asarray(return_periods, dtype=np.float64),
        "return_levels": levels,
        "bootstrap": boot,
        "empirical_return_periods": emp_t,
        "empirical_levels": emp_levels,
        "block_maxima": bm,
    }
