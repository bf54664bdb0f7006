"""ClimEx data: ingest, standardization and the four pipeline types (port of
``probunet_tpu/data/climex.py``).

Raw HR windows ``(B, H, W, C)`` in storage space become model inputs and
targets on whatever device they live on: LR = AvgPool(k)(HR); per-pixel
LR time statistics lifted to HR by pixel repetition; std with ddof=1;
nearest upsampling by default.

Host ingest: :func:`save_packed` / :func:`load_packed` (the ``pack``
artifact) and :class:`ClimexDataset`, whose sources are a packed file, an
in-memory ``hr=`` stack, a NetCDF directory or megafile (xarray, imported
only there) and the synthetic generator. The dataset keeps its (T, H, W, C)
stack and its statistics in host memory, as the JAX class does; the
physical transform and the statistics over the whole stack run on its
device (the CUDA device unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import glob as _glob
from typing import NamedTuple

import numpy as np
import torch

from probunet_tpu_torch.data import transforms
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields, synthetic_timestamps
from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.ops.resample import avg_pool, repeat_interleave_2d, upsample
from probunet_tpu_torch.utils.profiling import span

PIPELINE_TYPES = (
    "lr_to_hr",
    "lr_to_residuals",
    "lrinterp_to_residuals",
    "lrinterp_to_hr",
)

STANDARDIZATION_MODES = ("perpixel", "none", "pertimestep", "minmax")


class Standardization(NamedTuple):
    """Per-pixel statistics: LR (h, w, C) time stats of the pooled fields
    and the same lifted to the HR grid (H, W, C)."""

    lr_mean: torch.Tensor
    lr_std: torch.Tensor
    hr_mean: torch.Tensor
    hr_std: torch.Tensor
    lr_min: torch.Tensor | None = None
    lr_max: torch.Tensor | None = None
    hr_min: torch.Tensor | None = None
    hr_max: torch.Tensor | None = None


def compute_stats(hr: torch.Tensor, lowres_scale: int) -> Standardization:
    """Time mean/std (ddof=1)/min/max of the pooled LR stack (T, H, W, C),
    lifted to HR by pixel repetition."""
    lr = avg_pool(hr, lowres_scale)
    lr_mean = lr.mean(dim=0)
    lr_std = lr.std(dim=0, correction=1)
    lr_min = lr.amin(dim=0)
    lr_max = lr.amax(dim=0)

    def lift(a):
        return repeat_interleave_2d(a, lowres_scale)

    return Standardization(
        lr_mean=lr_mean, lr_std=lr_std,
        hr_mean=lift(lr_mean), hr_std=lift(lr_std),
        lr_min=lr_min, lr_max=lr_max,
        hr_min=lift(lr_min), hr_max=lift(lr_max),
    )


def standardize(x, mean, std, mn, mx, mode: str, epsilon: float) -> torch.Tensor:
    """One of the four standardization modes: perpixel, none, pertimestep
    (each sample's own spatial mean/std, ddof=0), minmax."""
    if mode == "none":
        return x
    if mode == "perpixel":
        return (x - mean) / (std + epsilon)
    if mode == "pertimestep":
        m = x.mean(dim=(1, 2), keepdim=True)
        s = x.std(dim=(1, 2), keepdim=True, correction=0)
        return (x - m) / (s + epsilon)
    if mode == "minmax":
        return (x - mn) / (mx - mn + epsilon)
    raise ValueError(f"unknown standardization {mode!r}")


def stats_rows(stats: Standardization, h0: int, h: int, lowres_scale: int) -> Standardization:
    """The statistics of HR rows [h0, h0 + h) (a block of image rows): the
    HR arrays' rows and the LR arrays' rows [h0 / k, (h0 + h) / k)."""
    k = lowres_scale
    return Standardization(*(
        None if a is None else a[h0 // k:(h0 + h) // k] if name.startswith("lr_")
        else a[h0:h0 + h] for name, a in zip(Standardization._fields, stats)))


def _item_stats(hr: torch.Tensor, rows) -> dict[str, torch.Tensor]:
    """Each item's spatial mean and std (ddof=0) of (B, H, W, C); with
    ``rows`` (a block of image rows, ``parallel.spatial.Rows``) over the
    whole image, in two passes (the mean, then the squared deviations from
    it) each summed over the ranks."""
    if rows is None:
        return {"mean": hr.mean(dim=(1, 2), keepdim=True),
                "std": hr.std(dim=(1, 2), keepdim=True, correction=0)}
    n = rows.whole(hr.shape[1]) * hr.shape[2]
    mean = rows.sum(hr.sum(dim=(1, 2), keepdim=True)) / n
    var = rows.sum(((hr - mean) ** 2).sum(dim=(1, 2), keepdim=True)) / n
    return {"mean": mean, "std": torch.sqrt(var)}


def preprocess_batch(
    hr: torch.Tensor,
    stats: Standardization,
    pipeline: str,
    lowres_scale: int,
    interp_mode: str = "nearest",
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
    rows=None,
) -> dict[str, torch.Tensor]:
    """Raw HR batch (B, H, W, C) -> model inputs/targets + diagnostics, for
    the four pipelines of ``probunet_tpu.data.climex.preprocess_batch``.

    ``rows`` (``parallel.spatial.Rows``): ``hr`` is this rank's block of
    image rows. The per-pixel statistics are sliced to its rows, the
    pooling and nearest upsampling stay local (the block's rows divide by
    the pooling factor), bilinear upsampling takes one LR row of each
    neighbour (``ops.resample.upsample_bilinear``), and the
    ``pertimestep`` item statistics are the whole image's."""
    if pipeline not in PIPELINE_TYPES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    k = lowres_scale
    if rows is not None:
        stats = stats_rows(stats, rows.h0, hr.shape[1], k)
    lr = avg_pool(hr, k)

    def st(x, mean, std, mn, mx):
        return standardize(x, mean, std, mn, mx, standardization, epsilon)

    def per_item(x, item):
        return (x - item["mean"]) / (item["std"] + epsilon)

    out = {"hr": hr, "lr": lr}
    item_stats = None
    if standardization == "pertimestep":
        # one set of per-item stats (the HR field's) standardizes both the
        # target and the lrinterp baseline, so residuals invert exactly
        item_stats = _item_stats(hr, rows)
        out["stand_stats"] = item_stats
        hr_stand = per_item(hr, item_stats)
    else:
        hr_stand = st(hr, stats.hr_mean, stats.hr_std, stats.hr_min, stats.hr_max)

    if pipeline.startswith("lr_"):
        lr_stand = (per_item(lr, _item_stats(lr, rows)) if standardization == "pertimestep"
                    else st(lr, stats.lr_mean, stats.lr_std, stats.lr_min, stats.lr_max))
        if pipeline == "lr_to_hr":
            return {"inputs": lr_stand, "targets": hr_stand, **out}

    lrinterp = upsample(lr, k, interp_mode, rows)
    out["lrinterp"] = lrinterp
    if pipeline == "lr_to_residuals":
        residual = hr_stand - upsample(lr_stand, k, interp_mode, rows)
        return {"inputs": lr_stand, "targets": residual, **out}

    if standardization == "pertimestep":
        lrinterp_stand = per_item(lrinterp, item_stats)
    else:
        lrinterp_stand = st(lrinterp, stats.hr_mean, stats.hr_std,
                            stats.hr_min, stats.hr_max)
    if pipeline == "lrinterp_to_residuals":
        return {"inputs": lrinterp_stand, "targets": hr_stand - lrinterp_stand, **out}
    return {"inputs": lrinterp_stand, "targets": hr_stand, **out}


def lrinterp_from_batch(batch: dict[str, torch.Tensor], lowres_scale: int,
                        interp_mode: str = "nearest", rows=None) -> torch.Tensor:
    """The interpolated-LR baseline field for any pipeline's batch dict;
    ``rows``: the batch is a block of image rows."""
    if "lrinterp" in batch:
        return batch["lrinterp"]
    return upsample(batch["lr"], lowres_scale, interp_mode, rows)


def invstand_residual(
    residual: torch.Tensor,
    stats: Standardization,
    pipeline: str,
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
    item_stats: dict | None = None,
) -> torch.Tensor:
    """Invert the standardization of a model output; ``item_stats`` is the
    ``stand_stats`` dict of :func:`preprocess_batch` (pertimestep only)."""
    to_hr = pipeline in ("lr_to_hr", "lrinterp_to_hr")
    if standardization == "none":
        return residual
    if standardization == "perpixel":
        scaled = residual * (stats.hr_std + epsilon)
        return scaled + stats.hr_mean if to_hr else scaled
    if standardization == "minmax":
        scaled = residual * (stats.hr_max - stats.hr_min + epsilon)
        return scaled + stats.hr_min if to_hr else scaled
    if standardization == "pertimestep":
        if item_stats is None:
            raise ValueError("pertimestep inversion needs item_stats")
        scaled = residual * (item_stats["std"] + epsilon)
        return scaled + item_stats["mean"] if to_hr else scaled
    raise ValueError(f"unknown standardization {standardization!r}")


def residual_to_hr(
    residual: torch.Tensor,
    lrinterp: torch.Tensor,
    stats: Standardization,
    pipeline: str = "lrinterp_to_residuals",
    epsilon: float = 1e-10,
    standardization: str = "perpixel",
    item_stats: dict | None = None,
) -> torch.Tensor:
    """Model output (standardized) -> HR field in storage units: lrinterp +
    unstandardized residual, or the unstandardized field itself for the
    ``*_to_hr`` pipelines."""
    inv = invstand_residual(residual, stats, pipeline, epsilon,
                            standardization, item_stats)
    if pipeline in ("lr_to_hr", "lrinterp_to_hr"):
        return inv
    return lrinterp + inv


def save_packed(path: str, hr: np.ndarray, timestamps=None,
                timestamps_float=None) -> None:
    """Write the packed-array artifact (the ``pack`` command's output): one
    .npz with the (T, H, W, C) float32 stack + timestamp features."""
    np.savez(
        path,
        hr=np.asarray(hr, np.float32),
        timestamps=(np.zeros(len(hr), np.float32)
                    if timestamps is None else np.asarray(timestamps)),
        timestamps_float=(np.zeros(len(hr), np.float64)
                          if timestamps_float is None
                          else np.asarray(timestamps_float)),
    )


def load_packed(path: str):
    """Read a packed artifact -> (hr, timestamps, ts_float); a .npy stack is
    memory-mapped (numpy reads an .npz's arrays whole)."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r"), None, None
    z = np.load(path, mmap_mode="r")
    return z["hr"], z["timestamps"], z["timestamps_float"]


# days of the stack a host-to-device copy takes at a time, so that a
# memory-mapped stack is never copied whole on the host
_UPLOAD_DAYS = 256


def _upload(hr: np.ndarray, device: torch.device) -> torch.Tensor:
    out = torch.empty(hr.shape, dtype=torch.float32, device=device)
    for s in range(0, hr.shape[0], _UPLOAD_DAYS):
        chunk = np.array(hr[s: s + _UPLOAD_DAYS], dtype=np.float32)
        out[s: s + _UPLOAD_DAYS].copy_(torch.from_numpy(chunk))
    return out


class ClimexDataset:
    """(T, H, W, C) HR stack in host memory + stats + batch assembly.

    Sources, in priority order:
      - ``packed`` artifact (the ``pack`` command's .npz, or a .npy stack),
        cropped to ``coords`` when its grid is larger;
      - ``hr`` array passed directly;
      - synthetic generator (``synthetic=True``, or no datadir/megafile);
      - NetCDF directory or megafile via xarray.

    ``device``: where the physical transform and the statistics are
    computed and where :meth:`batch` puts its tensors (the CUDA device
    unless the caller passes ``device="cpu"``; raises without one).
    """

    def __init__(
        self,
        datadir: str | None = None,
        years=range(1960, 2020),
        variables=("pr", "tasmin", "tasmax"),
        coords=(120, 184, 120, 184),
        pipeline: str = "lr_to_hr",
        lowres_scale: int = 4,
        transfo: bool = False,
        megafile: str | None = None,
        interp_mode: str = "nearest",
        epsilon: float = 1e-10,
        hr: np.ndarray | None = None,
        timestamps: np.ndarray | None = None,
        timestamps_float: np.ndarray | None = None,
        synthetic: bool = False,
        synthetic_seed: int = 0,
        standardization: str = "perpixel",
        pad_to_multiple: bool = False,
        packed: str | None = None,
        device: str | torch.device | None = "cuda",
    ):
        self.device = resolve_device(device)
        self.variables = tuple(variables)
        self.nvars = len(self.variables)
        self.coords = tuple(coords)
        self.pipeline = pipeline
        self.lowres_scale = int(lowres_scale)
        self.transfo = bool(transfo)
        self.interp_mode = interp_mode
        self.epsilon = float(epsilon)
        if standardization not in STANDARDIZATION_MODES:
            raise ValueError(f"unknown standardization {standardization!r}")
        self.standardization = standardization
        self.years = list(years)
        self.lat = self.lon = None    # set by the NetCDF ingest

        if packed is not None:
            hr, ts, tsf = load_packed(packed)
            if ts is not None and timestamps is None:
                timestamps, timestamps_float = ts, tsf
            c = self.coords
            hr = np.ascontiguousarray(
                hr[:, c[2]:c[3], c[0]:c[1], :]
                if hr.shape[1] > c[3] - c[2] else hr
            )
        elif hr is not None:
            hr = np.asarray(hr, dtype=np.float32)
        elif synthetic or datadir is None and megafile is None:
            h = self.coords[1] - self.coords[0]
            w = self.coords[3] - self.coords[2]
            num_days = 365 * max(1, len(self.years))
            hr = synthetic_climex_fields(
                num_days, h, w, self.variables, seed=synthetic_seed
            )
        else:
            hr, nc_ts, nc_tsf = self._load_netcdf(datadir, megafile)
            if timestamps is None and nc_ts is not None:
                timestamps, timestamps_float = nc_ts, nc_tsf

        # optional edge-padding of H/W to pooling multiples (full-domain
        # work: 280 is not divisible by 16); `orig_shape` is the unpadded grid
        self.orig_shape = hr.shape
        if pad_to_multiple:
            k = self.lowres_scale
            ph = (-hr.shape[1]) % k
            pw = (-hr.shape[2]) % k
            if ph or pw:
                hr = np.pad(hr, ((0, 0), (0, ph), (0, pw), (0, 0)),
                            mode="edge")

        t = hr.shape[0]
        if timestamps is None or timestamps_float is None:
            start = self.years[0] if self.years else 1960
            timestamps, timestamps_float = synthetic_timestamps(t, start_year=start)
        self.timestamps = np.asarray(timestamps, dtype=np.float32)
        self.timestamps_float = np.asarray(timestamps_float, dtype=np.float64)

        # the transform into storage space and the statistics on the device;
        # the stack and the statistics come back to the host
        x = _upload(hr, self.device)
        if self.transfo:
            x = transforms.apply_physical_transform(x, self.variables)
            hr = x.cpu().numpy()
        self.hr = hr  # (T, H, W, C), storage space, float32, host memory
        self.stats = Standardization(*(
            None if s is None else s.cpu().numpy()
            for s in compute_stats(x, self.lowres_scale)))
        self._device_stats: dict[torch.device, Standardization] = {}

    # ------------------------------------------------------------------
    def _load_netcdf(self, datadir: str | None, megafile: str | None):
        """(hr, timestamps, timestamps_float) of the NetCDF files of
        ``years`` x ``variables`` in ``datadir`` (cropped to ``coords``), or
        of a pre-cropped ``megafile``; the timestamps are None when the time
        coordinate does not convert."""
        try:
            import xarray as xr
        except ImportError as e:
            raise ImportError(
                "xarray is required for NetCDF ingest; pass hr= directly, use "
                "synthetic=True, or install xarray/h5netcdf"
            ) from e

        c = self.coords

        def select_coords(ds):
            return ds.isel(rlon=slice(c[0], c[1]), rlat=slice(c[2], c[3]))

        if megafile is None:
            files = []
            for year in self.years:
                for var in self.variables:
                    matches = _glob.glob(f"{datadir}/*_{var}_*_{year}_*")
                    if not matches:
                        raise FileNotFoundError(
                            f"no NetCDF file for var={var} year={year} in {datadir}"
                        )
                    files.append(matches[0])
            data = xr.open_mfdataset(
                paths=files,
                engine="h5netcdf",
                preprocess=select_coords,
                data_vars="minimal",
                coords="minimal",
                compat="override",
                parallel=False,
            )[list(self.variables)]
        else:
            data = xr.open_dataset(megafile, engine="h5netcdf")[list(self.variables)]

        # 2-D geographic coordinates for geo-referenced maps
        names = getattr(data, "variables", {})
        self.lon = np.asarray(data["lon"]) if "lon" in names else None
        self.lat = np.asarray(data["lat"]) if "lat" in names else None
        ts = tsf = None
        try:
            time = data.indexes["time"].to_datetimeindex()
            ts = np.asarray(transforms.cyclic_time_features(time.month, time.day),
                            dtype=np.float32)
            tsf = transforms.date_to_float(time)
        except Exception as e:  # any failure of the calendar conversion
            import warnings

            warnings.warn(
                f"NetCDF time coordinate could not be converted "
                f"({type(e).__name__}: {e}); falling back to synthetic "
                f"timestamps", stacklevel=2,
            )
            ts = tsf = None

        drop = [v for v in ("lat", "lon") if v in data.variables]
        arr = data.drop_vars(drop).to_array()  # (var, time, rlat, rlon)
        arr = arr.transpose("time", "rlat", "rlon", "variable")
        return np.asarray(arr.to_numpy(), dtype=np.float32), ts, tsf

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.hr.shape[0]

    def get_hr_batch(self, idx: np.ndarray) -> np.ndarray:
        """Raw HR slice (host memory) for a batch of time indices."""
        with span("data.gather"):
            return self.hr[np.asarray(idx)]

    def device_stats(self, device: torch.device) -> Standardization:
        """The statistics as tensors on ``device``, copied there once."""
        device = torch.device(device)
        st = self._device_stats.get(device)
        if st is None:
            st = Standardization(*(None if s is None else torch.from_numpy(s).to(device)
                                   for s in self.stats))
            self._device_stats[device] = st
        return st

    def preprocess(self, hr_batch: torch.Tensor) -> dict[str, torch.Tensor]:
        """Batch preprocessing on ``hr_batch``'s device (see preprocess_batch)."""
        return preprocess_batch(
            hr_batch,
            self.device_stats(hr_batch.device),
            self.pipeline,
            self.lowres_scale,
            self.interp_mode,
            self.epsilon,
            self.standardization,
        )

    def batch(self, idx: np.ndarray) -> dict:
        """Full item dict for a batch of indices on the dataset's device
        (inputs/targets/timestamps/hr/lr[/lrinterp] tensors,
        timestamps_float numpy), the reference's ``__getitem__`` keys."""
        idx = np.asarray(idx)
        out = self.preprocess(torch.from_numpy(self.get_hr_batch(idx)).to(self.device))
        out["timestamps"] = torch.from_numpy(self.timestamps[idx]).to(self.device)
        out["timestamps_float"] = self.timestamps_float[idx]
        return out

    def invstand_residual(self, residual: torch.Tensor, item_stats=None) -> torch.Tensor:
        return invstand_residual(
            residual, self.device_stats(residual.device), self.pipeline,
            self.epsilon, self.standardization, item_stats,
        )

    def residual_to_hr(self, residual: torch.Tensor, lrinterp: torch.Tensor,
                       item_stats=None) -> torch.Tensor:
        return residual_to_hr(
            residual, lrinterp, self.device_stats(residual.device), self.pipeline,
            self.epsilon, self.standardization, item_stats,
        )
