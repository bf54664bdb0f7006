"""Training and evaluation steps and the epoch loop (port of
``probunet_tpu/train/loop.py``).

``make_train_step`` is the ELBO training step (``bench.py``'s default
mode in the JAX package): device-side preprocessing of a raw HR batch,
the posterior ELBO at M = ``ensemble_size`` with the U-Net's dropout on,
its backward (through kernels A′ or B′, and C′ or D by the model's
GroupNorm route), and AdamW as optax
computes it. Its random numbers come from a generator seeded from
(seed, step) on the batch's device. ``make_eval_step`` is the no-grad
ELBO users call between epochs and in ``bench.py``'s eval mode (M =
``eval_ensemble_size``, beta_1 = 0, no dropout). ``train_epoch``,
``eval_model`` and :class:`Trainer` loop them over in-memory HR tensors
(N, H, W, C); taking a ``data.climex.ClimexDataset`` as the JAX loop does,
prefetch, sample plots and mesh steps are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import torch

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.data.climex import Standardization, preprocess_batch
from probunet_tpu_torch.data.loader import Batches, to_device
from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.train.early_stop import EarlyStopper
from probunet_tpu_torch.train.schedule import beta_schedule
from probunet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    global_norm,
    step_generator,
)


def make_elbo_loss_fn(model: ProbabilisticUNet, cfg: Config, training: bool = True,
                      fused: bool = True) -> Callable:
    """ELBO loss of (hr_batch, stats, generator, beta_0, beta_1[, eps,
    seeds]) -> (total, metrics). ``training``: M = ``ensemble_size`` and
    the U-Net's dropout on; else M = ``eval_ensemble_size``, no dropout.
    ``fused`` selects the reconstruction route (kernel A, or
    ``Fcomb.ensemble`` + kernel B). ``eps``/``seeds`` override the draws
    from ``generator`` (the tests hand both packages the same values)."""
    data_cfg, loss_cfg = cfg.data, cfg.loss
    m_size = cfg.train.ensemble_size if training else cfg.train.eval_ensemble_size

    def loss_fn(hr_batch: torch.Tensor, stats: Standardization,
                generator: torch.Generator, beta_0: float, beta_1: float,
                eps: torch.Tensor | None = None, seeds: torch.Tensor | None = None):
        batch = preprocess_batch(
            hr_batch, stats, data_cfg.pipeline, data_cfg.lowres_scale,
            data_cfg.interp_mode, data_cfg.epsilon, data_cfg.standardization)
        return model.elbo(batch["inputs"], batch["targets"], M=m_size,
                          loss_type=loss_cfg.loss_type, beta_0=beta_0, beta_1=beta_1,
                          alpha=loss_cfg.alpha, generator=generator, eps=eps,
                          fused=fused, training=training, seeds=seeds)

    return loss_fn


def make_train_step(model: ProbabilisticUNet, cfg: Config, fused: bool = True) -> Callable:
    """The ELBO train step:

        step(state, hr_batch, stats, beta_0, beta_1[, eps, seeds])
            -> (state, {"loss", "recon", "kl_mean", "grad_norm"})

    ``hr_batch`` is the raw HR window (B, H, W, C) in storage space, on the
    state's device. The state's model is updated in place and its step
    advanced; ``grad_norm`` is the global norm of the raw gradients (0-d
    tensors on the device; nothing waits for the device)."""
    loss_fn = make_elbo_loss_fn(model, cfg, training=True, fused=fused)

    def step(state: TrainState, hr_batch: torch.Tensor, stats: Standardization,
             beta_0: float, beta_1: float, eps: torch.Tensor | None = None,
             seeds: torch.Tensor | None = None):
        gen = step_generator(state.seed, state.step, hr_batch.device)
        loss, metrics = loss_fn(hr_batch, stats, gen, beta_0, beta_1, eps, seeds)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # optax decays every parameter: one that autograd does not reach
        # (the prior at beta_1 = 0) gets a zero gradient, not None
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grad_norm = global_norm(grads)
        state.optimizer.step(grads)
        state.step += 1
        return state, {"loss": loss.detach(), "recon": metrics["recon"].detach(),
                       "kl_mean": metrics["kl_mean"].detach(), "grad_norm": grad_norm}

    return step


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


def _hr_batches(hr: torch.Tensor, batch_size: int, device: torch.device,
                shuffle: bool = False, seed: int = 0):
    """Drop-last batches of the HR windows ``hr`` (N, H, W, C), copied to
    ``device``."""
    for idx in Batches(len(hr), batch_size, shuffle=shuffle, seed=seed):
        yield to_device(hr[torch.from_numpy(idx)], device)


def train_epoch(step_fn: Callable, state: TrainState, hr_train: torch.Tensor,
                stats: Standardization, cfg: Config, beta_0: float, beta_1: float,
                epoch: int, logger=None, ckpt=None) -> tuple[TrainState, dict[str, float]]:
    """One training epoch over the HR windows ``hr_train`` (N, H, W, C),
    shuffled from ``cfg.train.seed + epoch``, drop-last (reference
    src/train_prob_unet_model.py:105-158). With ``ckpt`` and
    ``cfg.train.checkpoint_every`` > 0 a checkpoint is written every N
    steps."""
    dev = next(state.model.parameters()).device
    recon_vals, kl_vals = [], []
    every = cfg.train.checkpoint_every
    t0 = time.time()
    n = 0
    for hr in _hr_batches(hr_train, cfg.train.batch_size, dev, shuffle=True,
                          seed=cfg.train.seed + epoch):
        state, metrics = step_fn(state, hr, stats, beta_0, beta_1)
        n += 1
        if logger is not None and n % cfg.train.log_every == 0:
            logger.log(metrics, step=state.step, kind="train")
        if ckpt is not None and every and state.step % every == 0:
            ckpt.save(state.step, state, extra={"epoch": epoch})
        recon_vals.append(metrics["recon"])
        kl_vals.append(metrics["kl_mean"])
    if not recon_vals:
        raise ValueError("train_epoch: fewer items than one batch")
    # one host sync at the epoch's end
    mean_recon = float(torch.stack(recon_vals).mean())
    mean_kl = float(torch.stack(kl_vals).mean())
    dt = time.time() - t0
    return state, {"recon": mean_recon, "kl": mean_kl, "steps_per_sec": n / dt,
                   "samples_per_sec": n * cfg.train.batch_size / dt}


class Trainer:
    """Training with beta annealing, per-epoch validation, early stopping
    and checkpointing (the reference's training script, src/main.py:107-238), over
    in-memory HR windows. Runs on the CUDA device unless the caller passes
    ``device="cpu"``; builds the model from ``cfg`` (seeded from
    ``cfg.train.seed``, with ``cfg.train``'s remat setting) unless it is
    given one or a ``state``; a caller who wants the composed GroupNorm
    route builds the model with ``gn_impl="composed"`` and passes it."""

    def __init__(self, cfg: Config, hr_train: torch.Tensor, stats: Standardization,
                 hr_val: torch.Tensor | None = None, val_stats: Standardization | None = None,
                 model: ProbabilisticUNet | None = None, logger=None,
                 checkpoint_manager=None, state: TrainState | None = None,
                 fused: bool = True, device: str | torch.device | None = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hr_train, self.hr_val = hr_train, hr_val
        self.logger = logger
        self.ckpt = checkpoint_manager
        if state is None:
            if model is None:
                model = ProbabilisticUNet.from_config(
                    cfg, torch.Generator().manual_seed(cfg.train.seed), device=self.device)
            state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                                       weight_decay=cfg.train.weight_decay,
                                       grad_clip=cfg.train.grad_clip, accum=cfg.train.accum,
                                       device=self.device)
        self.state = state
        self.model = state.model
        self.stats = Standardization(*[s.to(self.device) for s in stats])
        self.val_stats = (Standardization(*[s.to(self.device) for s in val_stats])
                          if val_stats is not None else self.stats)
        self.train_step = make_train_step(self.model, cfg, fused=fused)
        self.eval_step = make_eval_step(self.model, cfg, fused=fused)
        self.stopper = EarlyStopper(cfg.train.patience, cfg.train.min_delta)
        self.history = {"train_crps": [], "train_kl": [], "val_crps": [], "val_kl": []}

    def fit(self, num_epochs: int | None = None) -> dict:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.train.num_epochs
        for epoch in range(1, num_epochs + 1):
            beta_0, beta_1 = beta_schedule(epoch, num_epochs, cfg.loss.warmup_epochs,
                                           cfg.loss.max_beta_1)
            self.state, summary = train_epoch(
                self.train_step, self.state, self.hr_train, self.stats, cfg, beta_0,
                beta_1, epoch, logger=self.logger, ckpt=self.ckpt)
            self.history["train_crps"].append(summary["recon"])
            self.history["train_kl"].append(summary["kl"])
            rec = {"epoch": epoch, "beta_0": beta_0, "beta_1": beta_1,
                   **{f"train_{k}": v for k, v in summary.items()}}
            if self.hr_val is not None:
                val = eval_model(self.eval_step,
                                 _hr_batches(self.hr_val, cfg.train.batch_size, self.device),
                                 self.val_stats, cfg, epoch)
                self.history["val_crps"].append(val["recon"])
                self.history["val_kl"].append(val["kl"])
                rec.update({f"val_{k}": v for k, v in val.items()})
                stop, params = self.stopper.early_stop(val["recon"], self.model.state_dict())
                if self.ckpt is not None and self.stopper.counter == 0:
                    self.ckpt.save_best(self.stopper.best_params)
                if stop:
                    self.model.load_state_dict(params)
                    if self.logger:
                        self.logger.log({"early_stop_epoch": epoch}, kind="info")
                    break
            if self.logger:
                self.logger.log(rec, step=self.state.step, kind="epoch")
            if self.ckpt is not None:
                self.ckpt.save(self.state.step, self.state,
                               extra={"epoch": epoch, "beta_0": beta_0, "beta_1": beta_1})
        return self.history
