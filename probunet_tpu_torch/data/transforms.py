"""Physical variable transforms (port of ``probunet_tpu/data/transforms.py``).

Precipitation is stored as ``softplus_inv(pr)`` so decoded predictions stay
positive after ``softplus``; tasmax is stored as
``softplus_inv(tasmax - tasmin, c=0)`` so the decoded tasmax exceeds
tasmin. Branch-free ``torch.where`` forms; inputs are NHWC tensors. The
unit conversions take tensors or numpy arrays; the date helpers are numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def kgm2s_to_mmday(x):
    """kg/m^2/s -> mm/day (reference src/climex_utils.py:32-33)."""
    return x * 86400.0


def k_to_c(x):
    """Kelvin -> Celsius (reference src/climex_utils.py:49-50)."""
    return x - 273.15


def softplus_inv(x: torch.Tensor, threshold: float = 20.0,
                 c: float = 1e-7) -> torch.Tensor:
    """Inverse softplus: y = log(exp(x + c) - 1), identity above `threshold`."""
    safe = torch.where(x > threshold, torch.ones_like(x), x)  # no exp overflow
    inv = torch.log(torch.expm1(safe + c))
    return torch.where(x > threshold, x, inv)


def softplus(x: torch.Tensor, threshold: float = 20.0,
             c: float = 1e-7) -> torch.Tensor:
    """Softplus: y = log(exp(x) + 1) - c, identity above `threshold`."""
    safe = torch.where(x > threshold, torch.zeros_like(x), x)
    sp = torch.log1p(torch.exp(safe)) - c
    return torch.where(x > threshold, x, sp)


def apply_physical_transform(hr: torch.Tensor,
                             variables=("pr", "tasmin", "tasmax")) -> torch.Tensor:
    """Storage-space transforms of a (..., H, W, C) stack; channel order
    follows ``variables`` (pr, tasmin, tasmax)."""
    variables = tuple(variables)
    chans = []
    for i, v in enumerate(variables):
        x = hr[..., i]
        if v == "pr":
            x = softplus_inv(x)
        elif v == "tasmax" and "tasmin" in variables:
            j = variables.index("tasmin")
            x = softplus_inv(hr[..., i] - hr[..., j], c=0.0)
        chans.append(x)
    return torch.stack(chans, dim=-1)


def invert_physical_transform(x: torch.Tensor,
                              variables=("pr", "tasmin", "tasmax")) -> torch.Tensor:
    """Invert :func:`apply_physical_transform` back to physical units:
    pr = softplus(stored_pr); tasmax = tasmin + softplus(stored_delta, c=0)."""
    variables = tuple(variables)
    chans = {v: x[..., i] for i, v in enumerate(variables)}
    out = []
    for v in variables:
        if v == "pr":
            out.append(softplus(chans["pr"]))
        elif v == "tasmax" and "tasmin" in variables:
            out.append(chans["tasmin"] + softplus(chans["tasmax"], c=0.0))
        else:
            out.append(chans[v])
    return torch.stack(out, dim=-1)


def date_to_float(time_index) -> np.ndarray:
    """np.datetime64 array -> float64 ns-since-epoch (src/climex_utils.py:21-22)."""
    return np.asarray(time_index).astype("datetime64[ns]").astype(float)


def float_to_date(t) -> np.datetime64:
    """Inverse of :func:`date_to_float` (src/climex_utils.py:27-29)."""
    return np.datetime64(int(t), "ns")


def cyclic_time_features(month, day) -> np.ndarray:
    """sin/cos cyclic encoding summed as in reference src/climex_utils.py:117-119:
    timestamps = sin(2*pi*month/12) + cos(2*pi*day/31)."""
    return np.sin(2 * np.pi * np.asarray(month) / 12.0) + np.cos(
        2 * np.pi * np.asarray(day) / 31.0
    )
