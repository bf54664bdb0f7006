"""Synthetic ClimEx-like field generator (numpy).

A copy of ``probunet_tpu/data/synthetic.py:synthetic_climex_fields``:
that module cannot be imported without JAX (``probunet_tpu.data``'s
package init pulls in the JAX ingest code). Same seed, same draws, same
arithmetic — the output is bit-identical (asserted by the tests).

Fields are band-limited Fourier noise plus a seasonal cycle; ``pr`` is
nonnegative and heavy-tailed, ``tasmax > tasmin`` by construction.
"""

from __future__ import annotations

import numpy as np


def _smooth_noise(rng: np.random.Generator, t: int, h: int, w: int,
                  corr_len: float = 8.0) -> np.ndarray:
    """(T, H, W) spatially-smooth unit-variance noise via FFT filtering."""
    white = rng.standard_normal((t, h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    filt = np.exp(-0.5 * ((fy * corr_len) ** 2 + (fx * corr_len) ** 2) * (2 * np.pi) ** 2)
    spec = np.fft.fft2(white, axes=(1, 2)) * filt[None]
    out = np.fft.ifft2(spec, axes=(1, 2)).real
    std = out.std()
    return out / (std + 1e-12)


def synthetic_climex_fields(
    num_days: int,
    height: int = 128,
    width: int = 128,
    variables=("pr", "tasmin", "tasmax"),
    seed: int = 0,
    dtype=np.float32,
) -> np.ndarray:
    """Generate a (T, H, W, C) stack of daily HR fields in physical units.

    pr      mm/day, >= 0, skewed, occasional extremes;
    tasmin  deg C with an annual cycle and synoptic noise;
    tasmax  tasmin + positive diurnal range.
    """
    rng = np.random.default_rng(seed)
    t = num_days
    day = np.arange(t)
    season = np.sin(2 * np.pi * (day % 365) / 365.0)  # (T,)

    fields = {}
    # pr is always drawn (even when not requested) so the later draws
    # consume the same stream as the reference generator
    z = _smooth_noise(rng, t, height, width, corr_len=6.0)
    intensity = 1.2 + 0.8 * season[:, None, None]
    pr = np.exp(1.1 * z + 0.3 * _smooth_noise(rng, t, height, width, 20.0)) * intensity
    pr = np.where(z > -0.2, pr, 0.0) * 4.0
    fields["pr"] = pr

    base = 8.0 * season[:, None, None] + 4.0 * _smooth_noise(rng, t, height, width, 24.0)
    grad = np.linspace(-4.0, 4.0, height)[None, :, None]
    tasmin = base + grad + 1.5 * _smooth_noise(rng, t, height, width, 10.0) + 2.0
    diurnal = 6.0 + 2.0 * np.abs(_smooth_noise(rng, t, height, width, 16.0))
    fields["tasmin"] = tasmin
    fields["tasmax"] = tasmin + diurnal

    return np.stack([fields[v] for v in variables], axis=-1).astype(dtype)
