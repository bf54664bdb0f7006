"""EDM diffusion training and sampling (port of ``probunet_tpu/train/edm.py``).

The denoiser (:class:`~probunet_tpu_torch.models.edm.EDMPrecond`) learns
the standardized HR residual given the interpolated LR field as its
condition, so sampling gives downscaling ensembles through the same
``preprocess_batch`` / ``residual_to_hr`` plumbing as the Probabilistic
U-Net. Karras et al. 2022:

- training: sigma ~ LogNormal(p_mean, p_std), weight lambda(sigma) =
  (sigma^2 + sd^2) / (sigma sd)^2, loss = mean(lambda (D(y + sigma eps;
  sigma, cond) - y)^2);
- sampling: Heun's second-order method over sigma_i = (smax^(1/rho) +
  i / (N - 1) (smin^(1/rho) - smax^(1/rho)))^rho, i < N, and sigma_N = 0,
  the last step an Euler step alone.

Every draw takes a ``torch.Generator`` or the values themselves (sigma,
the unit noise, the dropout seed words, the sampler's initial noise), as
JAX's and torch's generators never give the same numbers. The schedule is
computed in f32 on the host, as the JAX sampler computes it, so the
branch at sigma_N = 0 needs no read from the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.data.climex import Standardization, preprocess_batch
from probunet_tpu_torch.train.state import TrainState, global_norm, step_generator


def edm_loss(model: nn.Module, target: torch.Tensor, condition: torch.Tensor | None = None,
             sigma_data: float = 1.0, p_mean: float = -1.2, p_std: float = 1.2,
             train: bool = True, generator: torch.Generator | None = None,
             sigma: torch.Tensor | None = None, noise: torch.Tensor | None = None,
             seeds: torch.Tensor | None = None) -> torch.Tensor:
    """The EDM denoising loss over one batch, target (B, H, W, C). ``sigma``
    (B,) and ``noise`` (the unit normal draw, target's shape) are drawn
    from ``generator`` when None, in that order, then the U-Net's dropout
    seed words (``seeds``) when ``train``."""
    b = target.shape[0]
    if sigma is None:
        sigma = torch.exp(p_mean + p_std * torch.randn(
            (b,), generator=generator, device=target.device))
    sigma = sigma.to(target.device).reshape(-1, 1, 1, 1)
    weight = (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2
    if noise is None:
        noise = torch.randn(target.shape, generator=generator, device=target.device,
                            dtype=target.dtype)
    denoised = model(target + sigma * noise.to(target.device), sigma.reshape(-1),
                     condition_img=condition, train=train, seeds=seeds, generator=generator)
    return torch.mean(weight * (denoised - target) ** 2)


def make_edm_train_step(model: nn.Module, cfg: Config) -> Callable:
    """The conditional-diffusion train step on the residual pipeline:

        step(state, hr_batch, stats[, sigma, noise, seeds]) -> (state, {"loss", "grad_norm"})

    ``hr_batch`` the raw HR window (B, H, W, C) on the state's device, the
    condition the standardized lrinterp (``preprocess_batch``'s inputs).
    The draws come from the step's generator, seeded from (seed, step),
    unless given; the state's AdamW updates the model in place."""
    data_cfg = cfg.data

    def step(state: TrainState, hr_batch: torch.Tensor, stats: Standardization,
             sigma: torch.Tensor | None = None, noise: torch.Tensor | None = None,
             seeds: torch.Tensor | None = None):
        gen = step_generator(state.seed, state.step, hr_batch.device)
        batch = preprocess_batch(hr_batch, stats, data_cfg.pipeline, data_cfg.lowres_scale,
                                 data_cfg.interp_mode, data_cfg.epsilon,
                                 data_cfg.standardization)
        loss = edm_loss(model, batch["targets"], batch["inputs"], train=True, generator=gen,
                        sigma=sigma, noise=noise, seeds=seeds)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grad_norm = global_norm(grads)
        state.optimizer.step(grads)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def edm_sigmas(num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0) -> np.ndarray:
    """The (num_steps + 1,) f32 noise levels of the sampler, the last 0."""
    i = np.arange(num_steps, dtype=np.float32) / np.float32(num_steps - 1)
    a = np.float32(sigma_max ** (1 / rho))
    span = np.float32(sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
    sigmas = (a + i * span) ** np.float32(rho)
    return np.concatenate([sigmas, np.zeros(1, np.float32)])


@torch.no_grad()
def edm_sample(model: nn.Module, shape: tuple, condition: torch.Tensor | None = None,
               num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
               rho: float = 7.0, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """Deterministic second-order (Heun) EDM sampler: (B, H, W, C) =
    ``shape`` samples in target (residual) space; ``residual_to_hr`` turns
    them into fields. ``noise``: the unit normal initial draw of ``shape``,
    drawn from ``generator`` when None. 2N - 1 denoiser calls."""
    sigmas = edm_sigmas(num_steps, sigma_min, sigma_max, rho)
    if noise is None:
        dev = condition.device if condition is not None else generator.device
        noise = torch.randn(shape, generator=generator, device=generator.device).to(dev)
    x = float(sigmas[0]) * noise.float()
    b = shape[0]

    def denoise(x, sigma):
        return model(x, torch.full((b,), float(sigma), device=x.device),
                     condition_img=condition)

    for s_cur, s_next in zip(sigmas[:-1], sigmas[1:]):
        d_cur = (x - denoise(x, s_cur)) / float(s_cur)
        step = float(s_next - s_cur)                     # f32, as the JAX scalars
        x_euler = x + step * d_cur
        if s_next > 0:   # the Heun correction, except on the last step to sigma = 0
            d_next = (x_euler - denoise(x_euler, s_next)) / float(s_next)
            x = x + float(np.float32(step) * np.float32(0.5)) * (d_cur + d_next)
        else:
            x = x_euler
    return x


def edm_ensemble(model: nn.Module, shape: tuple, condition: torch.Tensor | None,
                 num_members: int, generator: torch.Generator | None = None,
                 noise: torch.Tensor | None = None, **kwargs) -> torch.Tensor:
    """(B, M, H, W, C) diffusion ensemble with the condition shared: the M
    members run as one batch of M * B (member-major, the condition
    repeated), which equals the JAX sampler mapped over the members, since
    every operation of the U-Net acts on each sample alone. ``noise``: the
    members' unit normal initial draws (M, B, H, W, C), drawn from
    ``generator`` when None."""
    m, b = num_members, shape[0]
    if noise is None:
        noise = torch.randn((m, *shape), generator=generator, device=generator.device)
    noise = noise.reshape(m * b, *shape[1:])
    cond = None if condition is None else condition.repeat(m, 1, 1, 1)
    out = edm_sample(model, (m * b, *shape[1:]), cond, noise=noise, **kwargs)
    return out.reshape(m, *shape).transpose(0, 1)
