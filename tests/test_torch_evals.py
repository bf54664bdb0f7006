"""The port's evaluation functions against the JAX package on the same
seeded numpy inputs: the ensemble metrics, the histograms, the
dataset-mean PSD, the GEV toolkit and the exports of ``evals``.

Tolerances: f32 rtol 1e-5 / atol 1e-6 for the metrics and the PSD (the
same formulas, sums in another order); histogram counts exact (the same
edges, ``jnp.linspace``'s formula in the values' type); every ``gev``
result equal bit for bit (one numpy/scipy code at the same seed).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from probunet_tpu_torch import evals as tevals
from probunet_tpu_torch.evals import gev as tgev
from probunet_tpu_torch.evals import histograms as thist
from probunet_tpu_torch.evals import metrics as tmetrics
from probunet_tpu_torch.evals.psd import psd_over_dataset as t_psd_over_dataset

RTOL, ATOL = 1e-5, 1e-6
T, M, H, W, C = 6, 5, 16, 12, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    truth = rng.gamma(2.0, 2.0, (T, H, W, C)).astype(np.float32)
    ens = (truth[:, None] + rng.standard_normal((T, M, H, W, C))).astype(np.float32)
    lrinterp = (truth + 0.7 * rng.standard_normal((T, H, W, C))).astype(np.float32)
    return ens, truth, lrinterp


def test_metrics_match(data):
    from probunet_tpu.evals import metrics as jm

    ens, truth, lrinterp = data
    for name in ("crps_over_groundtruth", "compute_mae", "mae_over_groundtruth"):
        got = getattr(tmetrics, name)(torch.from_numpy(ens), torch.from_numpy(truth))
        want = getattr(jm, name)(ens, truth)
        assert set(got) == set(want) == {"mean", "std", "per_timestep"}
        for k in want:
            assert_close(got[k], want[k], RTOL, ATOL, f"{name} {k}")
    assert_close(tmetrics.ensemble_spread(ens), jm.ensemble_spread(ens), RTOL, ATOL, "spread")
    for pred in (ens, ens[:, 0]):
        got = tmetrics.residual_contribution(pred, lrinterp, truth)
        want = jm.residual_contribution(pred, lrinterp, jnp.asarray(truth))
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k], RTOL, ATOL, k)


@pytest.mark.parametrize("value_range,density", [(None, False), ((-1.0, 6.0), False),
                                                 ((2.0, 2.0), False), (None, True)])
def test_log_histogram_matches(data, value_range, density):
    from probunet_tpu.evals.histograms import log_histogram

    values = data[0][..., 0]
    got = thist.log_histogram(torch.from_numpy(values), 40, value_range, density)
    want = log_histogram(values, 40, value_range, density)
    assert_close(got[0], want[0], RTOL, ATOL, "centers")
    if density:
        assert_close(got[1], want[1], RTOL, 0.0, "density")
    else:
        assert np.array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_compare_histograms_matches(data):
    from probunet_tpu.evals.histograms import compare_histograms

    ens, truth, lrinterp = data
    fields = {"model": ens, "interp": lrinterp}
    got = thist.compare_histograms(truth, fields, bins=30)
    want = compare_histograms(truth, fields, bins=30)
    assert list(got) == list(want) == ["pr", "tasmin", "tasmax"]
    for var in want:
        assert list(got[var]) == list(want[var])
        assert_close(got[var]["bins"], want[var]["bins"], RTOL, ATOL, var)
        for name in ("gt", "model", "interp"):
            np.testing.assert_array_equal(got[var][name], want[var][name])


def test_psd_over_dataset_matches(data):
    from probunet_tpu.evals.psd import psd_over_dataset

    truth = data[1]
    got = t_psd_over_dataset(torch.from_numpy(truth))
    want = psd_over_dataset(truth)
    assert got.shape == want.shape
    assert_close(got, want, RTOL, ATOL * float(np.abs(want).max()), "psd")


def _assert_equal_tree(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_equal_tree(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, tuple):  # GEVFit, (periods, levels)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_tree(g, w, f"{what}[{i}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want), what


def test_gev_bit_equal():
    from probunet_tpu.evals import gev as jg

    rng = np.random.default_rng(5)
    daily = rng.gamma(2.0, 4.0, 365 * 9 + 40)
    ens = rng.gamma(2.0, 4.0, (365 * 6, 4))
    periods = (2, 5, 10, 50)
    bm = tgev.compute_annual_block_maxima(daily)
    _assert_equal_tree(bm, jg.compute_annual_block_maxima(daily))
    _assert_equal_tree(tgev.compute_annual_block_maxima(ens, 30),
                       jg.compute_annual_block_maxima(ens, 30))
    fit = tgev.gev_fit(bm)
    _assert_equal_tree(fit, jg.gev_fit(bm))
    _assert_equal_tree(tgev.gev_return_level(fit, periods), jg.gev_return_level(fit, periods))
    _assert_equal_tree(tgev.gev_parametric_bootstrap(fit, 9, periods, n_boot=15, seed=3),
                       jg.gev_parametric_bootstrap(fit, 9, periods, n_boot=15, seed=3))
    _assert_equal_tree(tgev.get_empirical_return_periods(bm),
                       jg.get_empirical_return_periods(bm))
    _assert_equal_tree(tgev.return_level_analysis(daily, periods, n_boot=12, seed=7),
                       jg.return_level_analysis(daily, periods, n_boot=12, seed=7))
    _assert_equal_tree(tgev.model_ensemble_analysis(ens, periods, n_boot=12, seed=7),
                       jg.model_ensemble_analysis(ens, periods, n_boot=12, seed=7))
    with pytest.raises(ValueError, match="365"):
        tgev.compute_annual_block_maxima(daily[:100])


def test_evals_exports_match_jax_but_weights():
    """The port's ``evals`` exports are the JAX package's, in order
    (``weight_function_analysis`` included since the WMSE weights are
    ported)."""
    import probunet_tpu.evals as jevals

    assert tevals.__all__ == jevals.__all__
    for name in tevals.__all__:
        assert callable(getattr(tevals, name)), name
