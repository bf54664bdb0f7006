"""The port's host ingest against the JAX package: the packed artifact,
``ClimexDataset`` from every source (packed, cropped packed, ``hr=``,
synthetic, edge padding, the NetCDF directory and megafile through the
fake xarray of ``tests/test_netcdf.py``), its statistics, ``preprocess``,
``batch`` and the inversions.

Tolerances: the stack and the timestamps exact where no transform runs;
with ``transfo`` the stack rtol 1e-6 / atol 1e-6 (the transforms' own
tolerance in ``test_torch_data.py``: the same formulas, ``log``/``expm1``
of two libraries); statistics rtol 1e-6 / atol 1e-6 (means and ddof=1
stds reduced in another order); the preprocessed batch rtol 1e-5 / atol
1e-5 (through the standardization's division).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_netcdf import COORDS, DAYS, _noleap_times, archive, fake_xarray  # noqa: F401
from torch_parity import assert_close

from probunet_tpu_torch.data import climex as tclimex
from probunet_tpu_torch.data import transforms as ttransforms
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields, synthetic_timestamps

VARS = ("pr", "tasmin", "tasmax")
STAT_TOL = 1e-6
BATCH_TOL = 1e-5


def _jax_ds(**kw):
    from probunet_tpu.data.climex import ClimexDataset

    return ClimexDataset(**kw)


def _torch_ds(**kw):
    return tclimex.ClimexDataset(device="cpu", **kw)


def _assert_same_dataset(got, want, transfo: bool = False):
    assert got.hr.shape == want.hr.shape and got.hr.dtype == want.hr.dtype
    if transfo:
        assert_close(got.hr, want.hr, STAT_TOL, STAT_TOL, "hr")
    else:
        assert np.array_equal(got.hr, want.hr)
    assert np.array_equal(got.timestamps, want.timestamps)
    assert np.array_equal(got.timestamps_float, want.timestamps_float)
    assert got.orig_shape == want.orig_shape
    for name in tclimex.Standardization._fields:
        assert_close(getattr(got.stats, name), getattr(want.stats, name),
                     STAT_TOL, STAT_TOL, name)


def test_timestamps_and_time_features_match():
    from probunet_tpu.data import transforms as jt
    from probunet_tpu.data.synthetic import synthetic_timestamps as jax_ts

    for got, want in zip(synthetic_timestamps(800, 2034), jax_ts(800, 2034)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    month, day = np.arange(1, 13), np.arange(3, 15)
    assert np.array_equal(ttransforms.cyclic_time_features(month, day),
                          jt.cyclic_time_features(month, day))
    dates = _noleap_times(2001)[:40]
    f = ttransforms.date_to_float(dates)
    assert np.array_equal(f, jt.date_to_float(dates))
    assert ttransforms.float_to_date(f[7]) == jt.float_to_date(f[7]) == dates[7]
    x = np.linspace(250.0, 320.0, 9, dtype=np.float32)
    assert np.array_equal(ttransforms.k_to_c(torch.from_numpy(x)).numpy(),
                          np.asarray(jt.k_to_c(jnp.asarray(x))))
    assert np.array_equal(ttransforms.kgm2s_to_mmday(torch.from_numpy(x * 1e-5)).numpy(),
                          np.asarray(jt.kgm2s_to_mmday(jnp.asarray(x * 1e-5))))


def test_packed_roundtrip_matches_jax(tmp_path):
    """Each package reads what either writes, with the same arrays (the
    files are compared by their arrays: a zip entry carries its time)."""
    from probunet_tpu.data import climex as jc

    hr = synthetic_climex_fields(20, 8, 8, VARS, seed=2)
    ts, tsf = synthetic_timestamps(20, 2000)
    paths = {"torch": str(tmp_path / "t.npz"), "jax": str(tmp_path / "j.npz")}
    tclimex.save_packed(paths["torch"], hr, ts, tsf)
    jc.save_packed(paths["jax"], hr, ts, tsf)
    loaded = [load(p) for p in paths.values() for load in (tclimex.load_packed, jc.load_packed)]
    for arrays in loaded[1:]:
        for got, want in zip(arrays, loaded[0]):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(loaded[0][0], hr) and np.array_equal(loaded[0][2], tsf)
    # no timestamps given: zeros of the stack's length, in both packages
    tclimex.save_packed(paths["torch"], hr)
    jc.save_packed(paths["jax"], hr)
    for got, want in zip(tclimex.load_packed(paths["torch"]), jc.load_packed(paths["jax"])):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    npy = str(tmp_path / "s.npy")
    np.save(npy, hr)
    got, want = tclimex.load_packed(npy), jc.load_packed(npy)
    assert got[1:] == want[1:] == (None, None)
    assert isinstance(got[0], np.memmap) and np.array_equal(got[0], want[0])


@pytest.mark.parametrize("transfo", [False, True])
def test_dataset_from_packed_with_crop(tmp_path, transfo):
    """A packed 24x24 grid cropped to the 16x16 ``coords`` window, and an
    uncropped .npy stack (memory-mapped, read-only)."""
    hr = synthetic_climex_fields(30, 24, 24, VARS, seed=4)
    path = str(tmp_path / "big.npz")
    tclimex.save_packed(path, hr, *synthetic_timestamps(30, 1990))
    kw = dict(packed=path, variables=VARS, coords=(4, 20, 6, 22),
              pipeline="lrinterp_to_residuals", lowres_scale=4, transfo=transfo)
    got, want = _torch_ds(**kw), _jax_ds(**kw)
    _assert_same_dataset(got, want, transfo)
    assert got.hr.shape == (30, 16, 16, 3)
    npy = str(tmp_path / "small.npy")
    np.save(npy, hr[:, :16, :16])
    kw.update(packed=npy, years=range(2001, 2002))
    _assert_same_dataset(_torch_ds(**kw), _jax_ds(**kw), transfo)


@pytest.mark.parametrize("transfo", [False, True])
def test_dataset_from_hr_synthetic_and_padding(transfo):
    hr = synthetic_climex_fields(12, 16, 16, VARS, seed=6)
    kw = dict(hr=hr, years=range(1999, 2000), variables=VARS, coords=(0, 16, 0, 16),
              pipeline="lr_to_residuals", lowres_scale=4, transfo=transfo)
    _assert_same_dataset(_torch_ds(**kw), _jax_ds(**kw), transfo)
    kw = dict(synthetic=True, synthetic_seed=3, years=range(1962, 1963), variables=("pr",),
              coords=(0, 8, 0, 8), pipeline="lrinterp_to_hr", lowres_scale=4,
              transfo=transfo)
    got = _torch_ds(**kw)
    _assert_same_dataset(got, _jax_ds(**kw), transfo)
    assert got.hr.shape == (365, 8, 8, 1)
    kw = dict(hr=hr[:, :14, :13], variables=VARS, pipeline="lrinterp_to_residuals",
              lowres_scale=4, transfo=transfo, pad_to_multiple=True)
    got = _torch_ds(**kw)
    _assert_same_dataset(got, _jax_ds(**kw), transfo)
    assert got.orig_shape == (12, 14, 13, 3) and got.hr.shape == (12, 16, 16, 3)


@pytest.mark.parametrize("pipeline,standardization", [
    ("lrinterp_to_residuals", "perpixel"), ("lr_to_hr", "minmax"),
    ("lr_to_residuals", "none"), ("lrinterp_to_hr", "pertimestep")])
def test_preprocess_batch_and_inversions_match(pipeline, standardization):
    hr = synthetic_climex_fields(10, 16, 16, VARS, seed=8)
    hr = hr + 0.5 * np.random.default_rng(8).standard_normal(hr.shape).astype(np.float32)
    kw = dict(hr=hr, variables=VARS, pipeline=pipeline, lowres_scale=4, transfo=True,
              standardization=standardization)
    got, want = _torch_ds(**kw), _jax_ds(**kw)
    idx = np.array([7, 2, 5])
    tb, jb = got.batch(idx), want.batch(idx)
    assert set(tb) == set(jb)
    for key in jb:
        if key == "stand_stats":
            for k in jb[key]:
                assert_close(tb[key][k], jb[key][k], BATCH_TOL, BATCH_TOL, k)
        elif key == "timestamps_float":
            assert np.array_equal(tb[key], jb[key])
        else:
            assert_close(tb[key], jb[key], BATCH_TOL, BATCH_TOL, key)
    assert tb["inputs"].device.type == "cpu"
    res = np.random.default_rng(9).standard_normal(jb["targets"].shape).astype(np.float32)
    ist_t = tb.get("stand_stats")
    ist_j = jb.get("stand_stats")
    assert_close(got.invstand_residual(torch.from_numpy(res), ist_t),
                 want.invstand_residual(jnp.asarray(res), ist_j), BATCH_TOL, BATCH_TOL,
                 "invstand_residual")
    lrinterp = tclimex.lrinterp_from_batch(tb, 4)
    assert_close(got.residual_to_hr(torch.from_numpy(res), lrinterp, ist_t),
                 want.residual_to_hr(jnp.asarray(res), jnp.asarray(lrinterp.numpy()), ist_j),
                 BATCH_TOL, BATCH_TOL, "residual_to_hr")
    # one device copy of the statistics, reused by every batch
    before = got.device_stats(torch.device("cpu"))
    got.preprocess(torch.from_numpy(got.get_hr_batch(idx)))
    assert got.device_stats(torch.device("cpu")) is before


def test_netcdf_directory_matches_jax(archive, fake_xarray):  # noqa: F811
    root, fields = archive
    kw = dict(datadir=root, years=range(2000, 2002), variables=("pr", "tasmin"),
              coords=COORDS, pipeline="lrinterp_to_residuals", lowres_scale=4)
    for transfo in (False, True):
        got, want = _torch_ds(transfo=transfo, **kw), _jax_ds(transfo=transfo, **kw)
        _assert_same_dataset(got, want, transfo)
        assert np.array_equal(got.lat, want.lat) and np.array_equal(got.lon, want.lon)
    c = COORDS
    assert got.hr.shape == (2 * DAYS, 8, 8, 2)
    with pytest.raises(FileNotFoundError, match="tasmax"):
        _torch_ds(**{**kw, "variables": ("pr", "tasmax")})
    raw = _torch_ds(**kw)
    assert np.array_equal(raw.hr[DAYS + 5, :, :, 1],
                          fields[(2001, "tasmin")][5, c[2]:c[3], c[0]:c[1]])


def test_netcdf_megafile_matches_jax(archive, fake_xarray, tmp_path):  # noqa: F811
    _, fields = archive
    mega = tmp_path / "megafile.npz"
    np.savez(mega, pr=fields[(2000, "pr")], tasmin=fields[(2000, "tasmin")],
             time=_noleap_times(2000))
    kw = dict(megafile=str(mega), years=range(2000, 2001), variables=("pr", "tasmin"),
              coords=COORDS, pipeline="lrinterp_to_residuals", lowres_scale=4,
              transfo=False)
    got = _torch_ds(**kw)
    _assert_same_dataset(got, _jax_ds(**kw))
    assert got.hr.shape == (DAYS, 12, 16, 2) and got.lat is None


def test_dataset_runs_on_cuda_unless_asked(monkeypatch):
    """The default device is CUDA: without a card the dataset raises before
    any ingest work; ``device="cpu"`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hr = synthetic_climex_fields(4, 8, 8, VARS, seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        tclimex.ClimexDataset(hr=hr, lowres_scale=4)
    with pytest.raises(ValueError, match="standardization"):
        tclimex.ClimexDataset(hr=hr, lowres_scale=4, device="cpu", standardization="x")
    assert tclimex.ClimexDataset(hr=hr, lowres_scale=4, device="cpu").device.type == "cpu"
