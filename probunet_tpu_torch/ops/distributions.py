"""Diagonal-Gaussian latent math (port of ``probunet_tpu/ops/distributions.py``).

``sigma = exp(log_sigma) + 1e-7`` as the reference constructs its Normal
scale. Sampling takes either an explicit ``torch.Generator`` or the noise
``eps`` itself, so tests can feed both packages the same numpy draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SIGMA_EPS = 1e-7


class DiagGaussian(NamedTuple):
    """Axis-aligned Gaussian over the last axis (the latent dimension)."""

    mu: torch.Tensor         # (..., D)
    log_sigma: torch.Tensor  # (..., D)

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(self.log_sigma) + _SIGMA_EPS

    def rsample(self, generator: torch.Generator | None = None,
                sample_shape: tuple[int, ...] = (),
                eps: torch.Tensor | None = None) -> torch.Tensor:
        """mu + sigma * eps with eps ~ N(0, I) of shape sample_shape +
        mu.shape, drawn from ``generator`` unless ``eps`` is given."""
        shape = tuple(sample_shape) + tuple(self.mu.shape)
        if eps is None:
            if generator is None:
                raise ValueError("rsample needs a generator or eps")
            eps = torch.randn(shape, generator=generator, device=self.mu.device,
                              dtype=self.mu.dtype)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps shape {tuple(eps.shape)} != {shape}")
        return self.mu + self.sigma * eps.to(self.mu.dtype)


def kl_diag_gaussians(q: DiagGaussian, p: DiagGaussian) -> torch.Tensor:
    """KL(q || p) summed over the latent axis -> shape q.mu.shape[:-1]."""
    sq, sp = q.sigma, p.sigma
    var_ratio = (sq / sp) ** 2
    t1 = ((q.mu - p.mu) / sp) ** 2
    return 0.5 * torch.sum(var_ratio + t1 - 1.0 - torch.log(var_ratio), dim=-1)


def kl_to_standard_normal(q: DiagGaussian) -> torch.Tensor:
    """KL(q || N(0, I)) summed over the latent axis."""
    sq = q.sigma
    return 0.5 * torch.sum(sq * sq + q.mu * q.mu - 1.0 - 2.0 * torch.log(sq), dim=-1)
