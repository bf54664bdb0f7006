"""Synthetic ClimEx-like fields and time features.

Copies of ``probunet_tpu/data/synthetic.py:synthetic_climex_fields`` and
``synthetic_timestamps`` (numpy): that module cannot be imported without
JAX (``probunet_tpu.data``'s package init pulls in the JAX ingest code).
Same seed, same draws, same arithmetic — the output is bit-identical
(asserted by the tests). :func:`synthetic_climex_fields_device` is the
device twin (``torch.fft`` on the tensors' device), the benchmark's data.

Fields are band-limited Fourier noise plus a seasonal cycle; ``pr`` is
nonnegative and heavy-tailed, ``tasmax > tasmin`` by construction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from probunet_tpu_torch.device import resolve_device

# the correlation lengths (pixels) of the five smooth fields, in draw order:
# pr's wet/dry field, pr's modulation, the temperature base, tasmin's
# synoptic noise, the diurnal range
DEVICE_CORR_LENS = (6.0, 20.0, 24.0, 10.0, 16.0)


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


def synthetic_white_noise(num_days: int, height: int, width: int,
                          generator: torch.Generator) -> torch.Tensor:
    """The five (T, H, W) standard-normal f32 fields of
    :func:`synthetic_climex_fields_device`, stacked (5, T, H, W) and drawn
    one after the other from ``generator`` on its device."""
    return torch.stack([torch.randn((num_days, height, width), generator=generator,
                                    device=generator.device)
                        for _ in DEVICE_CORR_LENS])


def fields_from_white(white: torch.Tensor,
                      variables=("pr", "tasmin", "tasmax")) -> torch.Tensor:
    """The (T, H, W, C) f32 stack in physical units made from the five white
    fields ``white`` (5, T, H, W): the arithmetic of the JAX package's
    ``synthetic_climex_fields_device`` after its draws, in f32 on
    ``white``'s device (the std over the whole field with ddof 0)."""
    _, t, h, w = white.shape
    dev = white.device

    def smooth(field, corr_len):
        fy = torch.fft.fftfreq(h, device=dev)[:, None]
        fx = torch.fft.fftfreq(w, device=dev)[None, :]
        filt = torch.exp(-0.5 * ((fy * corr_len) ** 2 + (fx * corr_len) ** 2)
                         * (2 * math.pi) ** 2)
        spec = torch.fft.fft2(field, dim=(1, 2)) * filt[None]
        out = torch.fft.ifft2(spec, dim=(1, 2)).real
        return out / (out.std(correction=0) + 1e-12)

    s = [smooth(f, c) for f, c in zip(white.float(), DEVICE_CORR_LENS)]
    day = torch.arange(t, device=dev)
    season = torch.sin(2 * math.pi * (day % 365) / 365.0)
    intensity = 1.2 + 0.8 * season[:, None, None]
    pr = torch.exp(1.1 * s[0] + 0.3 * s[1]) * intensity
    pr = torch.where(s[0] > -0.2, pr, 0.0) * 4.0
    base = 8.0 * season[:, None, None] + 4.0 * s[2]
    grad = torch.linspace(-4.0, 4.0, h, device=dev)[None, :, None]
    tasmin = base + grad + 1.5 * s[3] + 2.0
    diurnal = 6.0 + 2.0 * torch.abs(s[4])
    fields = {"pr": pr, "tasmin": tasmin, "tasmax": tasmin + diurnal}
    return torch.stack([fields[v] for v in variables], dim=-1).float()


def synthetic_climex_fields_device(
    num_days: int,
    height: int = 128,
    width: int = 128,
    variables=("pr", "tasmin", "tasmax"),
    seed: int = 0,
    device: str | torch.device | None = "cuda",
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Device twin of :func:`synthetic_climex_fields` (port of the JAX
    package's ``synthetic_climex_fields_device``): the (T, H, W, C) f32
    stack made on ``device`` (the CUDA device unless the caller passes
    ``device="cpu"``), with no host-to-device copy of the data.

    The five white-noise fields come from ``generator`` (a
    ``torch.Generator`` on ``device``; by default one seeded with ``seed``):
    they are not JAX's threefry bits, so the fields are not the JAX
    function's. Everything after the draw (:func:`fields_from_white`) is its
    arithmetic."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return fields_from_white(synthetic_white_noise(num_days, height, width, generator),
                             variables)


def synthetic_timestamps(num_days: int, start_year: int = 1960):
    """(timestamps, timestamps_float) mimicking the reference's cyclic time
    features over a 365-day (noleap) calendar (reference
    src/climex_utils.py:116-120)."""
    day_of_year = np.arange(num_days) % 365
    month = day_of_year // 31 + 1
    day = day_of_year % 31 + 1
    ts = np.sin(2 * np.pi * month / 12.0) + np.cos(2 * np.pi * day / 31.0)
    # float ns timestamps starting at start_year (approximate epoch offset)
    ns_per_day = 86400e9
    epoch_start = (start_year - 1970) * 365.25 * ns_per_day
    ts_float = epoch_start + np.arange(num_days) * ns_per_day
    return ts.astype(np.float32), ts_float.astype(np.float64)
