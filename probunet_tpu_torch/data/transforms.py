"""Physical variable transforms (port of ``probunet_tpu/data/transforms.py``).

Precipitation is stored as ``softplus_inv(pr)`` so decoded predictions stay
positive after ``softplus``; tasmax is stored as
``softplus_inv(tasmax - tasmin, c=0)`` so the decoded tasmax exceeds
tasmin. Branch-free ``torch.where`` forms; inputs are NHWC tensors.
"""

from __future__ import annotations

import torch


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
