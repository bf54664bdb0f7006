"""Radially-averaged power spectral density (port of
``probunet_tpu/evals/psd.py:psd``): the 2-D FFT power of each field,
averaged over integer wavenumber bins with an ``index_add`` segment sum.
"""

from __future__ import annotations

import numpy as np
import torch


def _radial_bins(h: int, w: int) -> tuple[np.ndarray, int]:
    """Integer radial wavenumber of each (ky, kx) FFT cell, and #bins."""
    fy = np.fft.fftfreq(h) * h
    fx = np.fft.fftfreq(w) * w
    r = np.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    bins = np.round(r).astype(np.int64)
    return bins, int(bins.max()) + 1


def psd(fields: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., k, C), k = max integer wavenumber + 1."""
    h, w, c = fields.shape[-3:]
    bins, nbins = _radial_bins(h, w)
    idx = torch.from_numpy(bins.reshape(-1)).to(fields.device)
    power = torch.abs(torch.fft.fft2(fields, dim=(-3, -2))) ** 2   # (..., H, W, C)
    flat = power.reshape(*power.shape[:-3], h * w, c)
    sums = torch.zeros(*flat.shape[:-2], nbins, c, dtype=flat.dtype, device=flat.device)
    sums.index_add_(flat.dim() - 2, idx, flat)
    counts = torch.bincount(idx, minlength=nbins).to(flat.dtype)
    return sums / counts[:, None]
