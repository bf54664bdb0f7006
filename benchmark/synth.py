"""Synthetic ClimEx-like days, made on the device from the run's seed: a
frozen copy of the measured program's device generator (band-limited
Fourier noise plus a seasonal cycle; pr nonnegative and heavy-tailed,
tasmax above tasmin), so that a change to the program cannot move the
traffic. The split is made one 365-day year at a time (each year's smooth
fields normalized over that year) and handed to the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# the correlation lengths (pixels) of the five smooth fields, in draw order
CORR_LENS = (6.0, 20.0, 24.0, 10.0, 16.0)
YEAR = 365


def _fields(white: torch.Tensor, variables) -> torch.Tensor:
    """(T, H, W, C) f32 physical fields from five white fields (5, T, H, W)."""
    _, t, h, w = white.shape
    dev = white.device

    def smooth(field, corr_len):
        fy = torch.fft.fftfreq(h, device=dev)[:, None]
        fx = torch.fft.fftfreq(w, device=dev)[None, :]
        filt = torch.exp(-0.5 * ((fy * corr_len) ** 2 + (fx * corr_len) ** 2)
                         * (2 * math.pi) ** 2)
        out = torch.fft.ifft2(torch.fft.fft2(field, dim=(1, 2)) * filt[None], dim=(1, 2)).real
        return out / (out.std(correction=0) + 1e-12)

    s = [smooth(f, c) for f, c in zip(white.float(), CORR_LENS)]
    day = torch.arange(t, device=dev)
    season = torch.sin(2 * math.pi * (day % YEAR) / float(YEAR))
    intensity = 1.2 + 0.8 * season[:, None, None]
    pr = torch.exp(1.1 * s[0] + 0.3 * s[1]) * intensity
    pr = torch.where(s[0] > -0.2, pr, 0.0) * 4.0
    tasmin = (8.0 * season[:, None, None] + 4.0 * s[2]
              + torch.linspace(-4.0, 4.0, h, device=dev)[None, :, None] + 1.5 * s[3] + 2.0)
    diurnal = 6.0 + 2.0 * torch.abs(s[4])
    fields = {"pr": pr, "tasmin": tasmin, "tasmax": tasmin + diurnal}
    return torch.stack([fields[v] for v in variables], dim=-1).float()


def split_days(days: int, height: int, width: int, variables, generator: torch.Generator
               ) -> np.ndarray:
    """(days, H, W, C) f32 physical fields in host memory, drawn year by year
    from ``generator`` (on the device)."""
    out = np.empty((days, height, width, len(variables)), np.float32)
    for a in range(0, days, YEAR):
        n = min(YEAR, days - a)
        white = torch.randn((len(CORR_LENS), n, height, width), generator=generator,
                            device=generator.device)
        out[a:a + n] = _fields(white, variables).cpu().numpy()
    return out
