"""No-grad ELBO evaluation (port of the eval half of
``probunet_tpu/train/loop.py``).

``make_eval_step`` is the serve path users call between epochs and in
``bench.py``'s eval mode: device-side preprocessing of a raw HR batch, then
the posterior ELBO at M = ``eval_ensemble_size`` with beta_1 = 0, under
``torch.no_grad()``. The training step (AdamW, dropout, the kernels'
backward) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from probunet_tpu.config import Config
from probunet_tpu_torch.data.climex import Standardization, preprocess_batch
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet


def make_elbo_loss_fn(model: ProbabilisticUNet, cfg: Config, training: bool = False,
                      fused: bool = True) -> Callable:
    """ELBO loss of (hr_batch, stats, generator, beta_0, beta_1) ->
    (total, metrics). Only ``training=False`` (eval ensemble size, no
    dropout) is ported."""
    if training:
        raise NotImplementedError("the training ELBO is not ported yet")
    data_cfg, loss_cfg = cfg.data, cfg.loss
    m_size = cfg.train.eval_ensemble_size

    def loss_fn(hr_batch: torch.Tensor, stats: Standardization,
                generator: torch.Generator, beta_0: float, beta_1: float):
        batch = preprocess_batch(
            hr_batch, stats, data_cfg.pipeline, data_cfg.lowres_scale,
            data_cfg.interp_mode, data_cfg.epsilon, data_cfg.standardization)
        return model.elbo(batch["inputs"], batch["targets"], M=m_size,
                          loss_type=loss_cfg.loss_type, beta_0=beta_0, beta_1=beta_1,
                          alpha=loss_cfg.alpha, generator=generator, fused=fused)

    return loss_fn


def make_eval_step(model: ProbabilisticUNet, cfg: Config, fused: bool = True) -> Callable:
    """No-grad posterior ELBO: step(hr_batch, stats, generator) ->
    {"recon", "kl_mean", "loss"} (0-d tensors on the batch's device)."""
    loss_fn = make_elbo_loss_fn(model, cfg, training=False, fused=fused)

    @torch.no_grad()
    def step(hr_batch: torch.Tensor, stats: Standardization,
             generator: torch.Generator) -> dict[str, torch.Tensor]:
        total, metrics = loss_fn(hr_batch, stats, generator, 1.0, 0.0)
        return {"recon": metrics["recon"], "kl_mean": metrics["kl_mean"], "loss": total}

    return step


def eval_model(eval_step_fn: Callable, hr_batches: Iterable[torch.Tensor],
               stats: Standardization, cfg: Config, epoch: int = 0) -> dict[str, float]:
    """Mean recon / KL over in-memory HR batches. The posterior noise comes
    from one generator on the batches' device, seeded from
    (cfg.train.seed + 7919, epoch) and drawn in batch order."""
    recon_vals, kl_vals = [], []
    gen = None
    for hr in hr_batches:
        if gen is None:
            gen = torch.Generator(device=hr.device)
            gen.manual_seed((cfg.train.seed + 7919) * 1_000_003 + epoch)
        metrics = eval_step_fn(hr, stats, gen)
        recon_vals.append(metrics["recon"])
        kl_vals.append(metrics["kl_mean"])
    if not recon_vals:
        raise ValueError("eval_model: no batches")
    return {"recon": float(torch.stack(recon_vals).mean()),
            "kl": float(torch.stack(kl_vals).mean())}
