"""The port's EDA module (``probunet_tpu_torch/data/eda.py``, a numpy/scipy
copy) against the JAX package's ``data/eda.py``: every ``ClimexEDA``
method, the calendar helpers and the rank transform give the same arrays
bit for bit on one stack, in RAM and as a read-only ``np.memmap``, with
the default chunks and small ones (JAX ``tests/test_eda.py`` is the
oracle of what the values mean)."""

import numpy as np
import pytest

import probunet_tpu.data.eda as jax_eda

from probunet_tpu_torch.data import eda

STAT_NAMES = ("mean", "median", "q25", "q75", "min", "max")


@pytest.fixture(scope="module")
def stack():
    """Three noleap years at 8x8 of an annual cycle, pr with exact zeros."""
    rng = np.random.default_rng(1)
    t, h, w = 365 * 3, 8, 8
    cycle = np.sin(2 * np.pi * (np.arange(t) - 105) / 365)[:, None, None]
    base = 10 * cycle + rng.standard_normal((t, h, w))
    pr = np.where(base > 3.0, base - 3.0, 0.0)
    return np.stack([pr, base, base + 5], axis=-1).astype(np.float32)


def test_calendar_and_rank_match_jax():
    assert eda.SEASONS == jax_eda.SEASONS
    np.testing.assert_array_equal(eda.day_of_year(800), jax_eda.day_of_year(800))
    doy = np.arange(-3, 800)
    np.testing.assert_array_equal(eda.season_of_doy(doy), jax_eda.season_of_doy(doy))
    x = np.random.default_rng(0).standard_normal((50, 4, 3))
    x[x < 0] = 0.0
    np.testing.assert_array_equal(eda._rank(x, axis=0), jax_eda._rank(x, axis=0))


def _pairs(stack, tmp_path, kind):
    """(port EDA, JAX EDA) over the same data: in RAM, small chunks, or a
    read-only memmap of it."""
    kw = {}
    data = stack
    if kind == "chunks":
        kw = dict(row_chunk=3, time_chunk=101)
    elif kind == "memmap":
        path = tmp_path / "stack.dat"
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=stack.shape)
        mm[:] = stack
        mm.flush()
        data = np.memmap(path, dtype=np.float32, mode="r", shape=stack.shape)
        kw = dict(row_chunk=5, time_chunk=200)
    return eda.ClimexEDA(data, **kw), jax_eda.ClimexEDA(data, **kw)


@pytest.mark.parametrize("kind", ["ram", "chunks", "memmap"])
def test_every_method_matches_jax(stack, tmp_path, kind):
    port, ref = _pairs(stack, tmp_path, kind)
    assert (port.row_chunk, port.time_chunk) == (ref.row_chunk, ref.time_chunk)
    for var in ("pr", "tasmin", 2):
        a, b = port.seasonal_stats(var), ref.seasonal_stats(var)
        assert list(a) == list(b) == list(eda.SEASONS)
        for season in a:
            for stat in STAT_NAMES:
                np.testing.assert_array_equal(a[season][stat], b[season][stat])
        for season in eda.SEASONS:
            for stat in STAT_NAMES:
                np.testing.assert_array_equal(
                    port.interannual_seasonal_series(var, season, stat),
                    ref.interannual_seasonal_series(var, season, stat))
        for along in ("rlat", "rlon"):
            np.testing.assert_array_equal(port.doy_profile(var, along),
                                          ref.doy_profile(var, along))
        np.testing.assert_array_equal(port.spearman_crosscorrelation(var, (4, 3)),
                                      ref.spearman_crosscorrelation(var, (4, 3)))
        a, b = port.lagged_autocorrelation(var, (1, 2, 30)), \
            ref.lagged_autocorrelation(var, (1, 2, 30))
        assert list(a) == list(b) == [1, 2, 30]
        for lag in a:
            np.testing.assert_array_equal(a[lag], b[lag])
    ss = port.seasonal_stats("tasmin")
    assert ss["JJA"]["mean"].mean() > ss["DJF"]["mean"].mean()


def test_custom_doy_and_variables(stack):
    doy = (np.arange(stack.shape[0]) + 40) % 365
    kw = dict(variables=("a", "b", "c"), doy=doy)
    port, ref = eda.ClimexEDA(stack, **kw), jax_eda.ClimexEDA(stack, **kw)
    np.testing.assert_array_equal(port.season, ref.season)
    np.testing.assert_array_equal(port.doy_profile("b"), ref.doy_profile("b"))
    np.testing.assert_array_equal(port.seasonal_stats("c")["SON"]["q75"],
                                  ref.seasonal_stats("c")["SON"]["q75"])
