"""Exploratory data analysis over the packed ClimEx stack.

A copy of ``probunet_tpu/data/eda.py`` (numpy and scipy only; the port
imports nothing of the JAX package), bit-equal to it (asserted by the
tests). Like the JAX module it is imported by its path
(``probunet_tpu_torch.data.eda``); ``data/__init__.py`` does not export it.

Re-implementation of ``climexEDA`` (reference src/baseline/climex_utils.py:
367-696). The reference runs lazily over NetCDF with dask chunking (chunk
heuristic at :394-396) + bottleneck ``rankdata`` gufuncs (:529-540); here
the packed (T, H, W, C) array — an in-RAM ndarray OR a read-only
``np.memmap`` of the full multi-decade 280x280 domain — is analyzed in
bounded memory:

- per-pixel-over-time statistics (seasonal stat maps, Spearman cross- and
  auto-correlation) stream over ROW chunks: each chunk loads only
  (T, rows, W) of one variable, so peak RAM is ``row_chunk`` rows of the
  full series regardless of T;
- time-aggregate statistics (day-of-year profiles, interannual seasonal
  series) stream over TIME chunks with running accumulators (sums/counts
  per doy; one contiguous year at a time for the exact seasonal
  quantiles).

Rank transforms use scipy's ``rankdata(method="average")`` — the same
average-tie semantics as the reference's ``bottleneck.rankdata`` — so
fields with ties (pr has exact zeros) produce the reference's Spearman
values; an ordinal double-argsort rank would not.

Covers:
- seasonal interannual statistics (mean/median/quartiles/min/max per season
  per year, and their maps) — reference :436-464;
- day-of-year profiles along rlat/rlon — reference :467-526;
- Spearman cross-correlation maps against a reference pixel — reference
  :543-582 (rankdata gufunc at :529-540);
- lagged Spearman autocorrelation per pixel — reference :585-644.

Plotting lives in probunet_tpu_torch.utils.plotting (seasonal maps are plain
field panels: ``plot_seasonal_maps``).
"""

from __future__ import annotations

import mmap

import numpy as np
from scipy.stats import rankdata

SEASONS = {
    "DJF": (12, 1, 2),
    "MAM": (3, 4, 5),
    "JJA": (6, 7, 8),
    "SON": (9, 10, 11),
}

# noleap-calendar month of each day-of-year (0-based doy)
_MONTH_LEN = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
_DOY_MONTH = np.repeat(np.arange(1, 13), _MONTH_LEN)


def day_of_year(t: int) -> np.ndarray:
    """0-based day-of-year for a T-day noleap daily series starting Jan 1."""
    return np.arange(t) % 365


def season_of_doy(doy: np.ndarray) -> np.ndarray:
    """Season label index (0=DJF, 1=MAM, 2=JJA, 3=SON) per 0-based doy."""
    month = _DOY_MONTH[doy % 365]
    out = np.empty(month.shape, np.int8)
    for i, (_, months) in enumerate(SEASONS.items()):
        for m in months:
            out[month == m] = i
    return out


def _rank(x: np.ndarray, axis: int = 0) -> np.ndarray:
    """Average-tie rank transform along ``axis`` — the semantics of the
    reference's ``bottleneck.rankdata`` gufunc (reference
    src/baseline/climex_utils.py:529-540). pr fields contain exact zeros
    (ties), where an ordinal rank would skew the Spearman maps."""
    return rankdata(x, method="average", axis=axis).astype(np.float64)


def _pearson(a: np.ndarray, b: np.ndarray, axis: int = 0,
             in_place: bool = False) -> np.ndarray:
    """Pearson correlation along ``axis``. ``in_place=True`` centers the
    inputs in place (callers passing freshly-computed rank arrays they own
    — halves the peak working set of the chunked Spearman maps)."""
    if in_place:
        a -= a.mean(axis=axis, keepdims=True)
        b -= b.mean(axis=axis, keepdims=True)
    else:
        a = a - a.mean(axis=axis, keepdims=True)
        b = b - b.mean(axis=axis, keepdims=True)
    num = (a * b).sum(axis=axis)
    den = np.sqrt((a * a).sum(axis=axis) * (b * b).sum(axis=axis))
    return num / np.where(den == 0, 1.0, den)


class ClimexEDA:
    """EDA over a (T, H, W, C) daily stack (physical units).

    ``hr`` may be an in-RAM ndarray or a read-only ``np.memmap`` — every
    statistic streams over row- or time-chunks, so a 30-year full-domain
    stack (~10 GB/var) runs in bounded host RAM.

    ``variables`` names the channel axis; ``doy`` is the 0-based day-of-year
    per timestep (noleap) — defaults to a Jan-1-aligned series.

    ``row_chunk``/``time_chunk`` bound the working-set sizes (rows of the
    full series / timesteps of the full domain per load). The defaults
    target ~128 MB per loaded block (``_TARGET_BLOCK_BYTES``) — the analog
    of the reference's dask chunk-size heuristic
    (src/baseline/climex_utils.py:394-396).
    """

    _TARGET_BLOCK_BYTES = 128 * 1024 * 1024

    def __init__(self, hr: np.ndarray, variables=("pr", "tasmin", "tasmax"),
                 doy: np.ndarray | None = None,
                 row_chunk: int | None = None,
                 time_chunk: int | None = None):
        self.hr = hr if isinstance(hr, np.memmap) else np.asarray(hr)
        self.variables = tuple(variables)
        t, h, w = self.hr.shape[0], self.hr.shape[1], self.hr.shape[2]
        self.doy = day_of_year(t) if doy is None else np.asarray(doy)
        self.season = season_of_doy(self.doy)
        self.year = np.arange(t) // 365
        itemsize = self.hr.dtype.itemsize
        if row_chunk is None:
            row_chunk = max(1, self._TARGET_BLOCK_BYTES // (t * w * itemsize))
        if time_chunk is None:
            time_chunk = max(1, self._TARGET_BLOCK_BYTES // (h * w * itemsize))
        self.row_chunk = min(row_chunk, h)
        self.time_chunk = min(time_chunk, t)

    def _ci(self, var) -> int:
        return self.variables.index(var) if isinstance(var, str) else var

    def _var(self, var) -> np.ndarray:
        """Whole-series view of one variable (only materialized by callers
        chunk-wise; kept for API compatibility)."""
        return self.hr[..., self._ci(var)]

    def _drop_pages(self):
        """Release resident memmap pages (MADV_DONTNEED) after each chunk
        copy — without this the kernel keeps every touched file page in the
        process RSS and 'streaming' over a 10 GB stack still peaks at 10 GB
        (measured; clean pages, but indistinguishable from a leak in
        ru_maxrss). No-op for in-RAM arrays."""
        mm = getattr(self.hr, "_mmap", None)
        if mm is not None:
            try:
                mm.madvise(mmap.MADV_DONTNEED)
            except (AttributeError, ValueError, OSError):
                pass

    def _row_blocks(self, var):
        """Yield (h0, h1, block) with block = in-RAM (T, rows, W) f64-safe
        slab of one variable — the bounded-RAM unit of every per-pixel
        statistic."""
        ci = self._ci(var)
        h = self.hr.shape[1]
        for h0 in range(0, h, self.row_chunk):
            h1 = min(h0 + self.row_chunk, h)
            # np.array(copy=True): a memmap slice is a VIEW (memmap is an
            # ndarray subclass, np.asarray copies nothing) — the slab must
            # be materialized in RAM BEFORE _drop_pages, or the dropped
            # pages refault from disk during the statistics pass.
            block = np.array(self.hr[:, h0:h1, :, ci], copy=True)
            self._drop_pages()
            yield h0, h1, block

    def _time_blocks(self, var):
        """Yield (t0, t1, block) with block = in-RAM (steps, H, W) slab."""
        ci = self._ci(var)
        t = self.hr.shape[0]
        for t0 in range(0, t, self.time_chunk):
            t1 = min(t0 + self.time_chunk, t)
            block = np.array(self.hr[t0:t1, :, :, ci], copy=True)
            self._drop_pages()
            yield t0, t1, block

    # ------------------------------------------------------------------
    def seasonal_stats(self, var) -> dict[str, dict[str, np.ndarray]]:
        """Per-season (H, W) maps of mean/median/q25/q75/min/max over all
        days in the season (reference :436-464, map flavor). Exact
        quantiles per pixel need the pixel's full series, so this streams
        over row chunks (each holds every timestep of `row_chunk` rows)."""
        h, w = self.hr.shape[1], self.hr.shape[2]
        names = ("mean", "median", "q25", "q75", "min", "max")
        out = {s: {n: np.empty((h, w)) for n in names} for s in SEASONS}
        sels = {name: self.season == i for i, name in enumerate(SEASONS)}
        for h0, h1, block in self._row_blocks(var):
            for name, sel in sels.items():
                xs = block[sel]
                d = out[name]
                d["mean"][h0:h1] = xs.mean(axis=0)
                d["median"][h0:h1] = np.median(xs, axis=0)
                d["q25"][h0:h1] = np.quantile(xs, 0.25, axis=0)
                d["q75"][h0:h1] = np.quantile(xs, 0.75, axis=0)
                d["min"][h0:h1] = xs.min(axis=0)
                d["max"][h0:h1] = xs.max(axis=0)
        return out

    def interannual_seasonal_series(self, var, season: str,
                                    stat: str = "mean") -> np.ndarray:
        """(n_years,) domain-aggregate of one season per year — the
        interannual variability series (reference :436-464). Streams one
        contiguous noleap year of the domain at a time (exact quantiles
        over each season-year's full pixel pool)."""
        ci = self._ci(var)
        si = list(SEASONS).index(season)
        fns = {"mean": np.mean, "median": np.median,
               "min": np.min, "max": np.max,
               "q25": lambda a: np.quantile(a, 0.25),
               "q75": lambda a: np.quantile(a, 0.75)}
        fn = fns[stat]
        sel = self.season == si
        vals = []
        for y in np.unique(self.year):
            ysel = self.year == y
            t0, t1 = np.flatnonzero(ysel)[[0, -1]]
            both = sel[t0:t1 + 1]
            if not both.any():
                continue
            block = np.asarray(self.hr[t0:t1 + 1, :, :, ci])  # one year
            self._drop_pages()
            vals.append(fn(block[both]))
        return np.array(vals)

    # ------------------------------------------------------------------
    def doy_profile(self, var, along: str = "rlat") -> np.ndarray:
        """Mean day-of-year cycle profiled along one spatial axis
        (reference :467-526): (365, H) for along='rlat', (365, W) for
        'rlon'. Streams over time chunks with per-doy running sums."""
        axis = 2 if along == "rlat" else 1  # average out the OTHER axis
        n_space = self.hr.shape[1] if along == "rlat" else self.hr.shape[2]
        sums = np.zeros((365, n_space), np.float64)
        counts = np.zeros((365,), np.int64)
        for t0, t1, block in self._time_blocks(var):
            prof = block.mean(axis=axis)             # (steps, H) or (steps, W)
            d = self.doy[t0:t1]
            np.add.at(sums, d, prof)
            np.add.at(counts, d, 1)
        counts = np.where(counts == 0, 1, counts)
        return (sums / counts[:, None]).astype(self.hr.dtype)

    # ------------------------------------------------------------------
    def spearman_crosscorrelation(self, var, ref_pixel: tuple[int, int]
                                  ) -> np.ndarray:
        """(H, W) Spearman correlation of every pixel's daily series with the
        series at ``ref_pixel`` (reference :543-582). Average-tie ranks
        (bottleneck.rankdata semantics); row-chunked."""
        ci = self._ci(var)
        ref_series = np.asarray(self.hr[:, ref_pixel[0], ref_pixel[1], ci])
        self._drop_pages()
        rref = _rank(ref_series, axis=0)
        rref_c = rref - rref.mean()                       # (T,), centered
        ssr = float((rref_c ** 2).sum())
        h, w = self.hr.shape[1], self.hr.shape[2]
        out = np.empty((h, w))
        for h0, h1, block in self._row_blocks(var):
            rx = _rank(block, axis=0)
            rx -= rx.mean(axis=0, keepdims=True)          # owned: in place
            num = np.tensordot(rref_c, rx, axes=(0, 0))
            den = np.sqrt((rx * rx).sum(axis=0) * ssr)
            out[h0:h1] = num / np.where(den == 0, 1.0, den)
        return out

    def lagged_autocorrelation(self, var, lags=(1, 2, 3, 5, 10)
                               ) -> dict[int, np.ndarray]:
        """{lag: (H, W)} Spearman autocorrelation of each pixel's series with
        itself shifted by ``lag`` days (reference :585-644). Row-chunked;
        both shifted copies of a chunk are ranked with average-tie ranks."""
        h, w = self.hr.shape[1], self.hr.shape[2]
        out = {lag: np.empty((h, w)) for lag in lags}
        for h0, h1, block in self._row_blocks(var):
            for lag in lags:
                a = _rank(block[:-lag], axis=0)
                b = _rank(block[lag:], axis=0)
                out[lag][h0:h1] = _pearson(a, b, axis=0, in_place=True)
        return out
