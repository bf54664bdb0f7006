"""Train state: model + optimizer + step + seed (port of
``probunet_tpu/train/state.py``).

The JAX package keeps (params, opt_state, step, rng) in one immutable
pytree; here the model's parameters are updated in place and
:class:`TrainState` bundles them with the optimizer, the step count and
the seed of the training stream. The step's random numbers come from a
generator seeded from (seed, step) (:func:`step_generator`), so a run
resumed from a checkpoint redraws the same noise, as the JAX step's
``fold_in(rng, step)`` does.

:class:`AdamW` is optax's ``adamw`` written out, with its
``clip_by_global_norm`` and ``MultiSteps`` wrappers, because
``torch.optim.AdamW`` and ``clip_grad_norm_`` differ from them:

- decoupled decay lr * wd * p on every parameter, its gradient zero or
  not (``torch.optim.AdamW`` skips a parameter whose ``.grad`` is None;
  here every parameter gets a gradient, zero where autograd gives none);
- the clip scales by max_norm / |g| only when |g| >= max_norm, with no
  1e-6 in the denominator;
- accumulation averages k micro-batch gradients (optax's running mean)
  and updates every k-th call; the calls in between leave the parameters
  as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch
from torch import nn

from probunet_tpu_torch.device import resolve_device


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors (optax's global_norm),
    a 0-d f32 tensor on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay), optionally behind
    clip_by_global_norm(grad_clip) and inside MultiSteps(accum)."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float = 1e-4,
                 weight_decay: float = 0.01, grad_clip: float = 0.0, accum: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, grad_clip
        self.accum, self.b1, self.b2, self.eps = accum, b1, b2, eps
        self.count = 0          # AdamW updates made
        self.mini_step = 0      # micro-batches accumulated since the last update
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if accum > 1 else []

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> bool:
        """Take one micro-batch's gradients (one per parameter, in order);
        returns whether the parameters were updated."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        if self.accum > 1:
            n = self.mini_step
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (n + 1) % self.accum
            if self.mini_step:
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.grad_clip:
            norm = global_norm(grads)
            if not bool(norm < self.grad_clip):
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.grad_clip)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        # bias corrections in f32, as optax computes decay ** count
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": [t.clone() for t in self.mu], "nu": [t.clone() for t in self.nu],
                "acc": [t.clone() for t in self.acc]}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu"), (self.acc, "acc")):
            if len(state[key]) != len(dst):
                raise ValueError(f"optimizer state {key!r}: {len(state[key])} tensors for "
                                 f"{len(dst)}")
            for d, s in zip(dst, state[key]):
                d.copy_(s)


def make_optimizer(params: Iterable[nn.Parameter], lr: float = 1e-4,
                   weight_decay: float = 0.01, grad_clip: float = 0.0,
                   accum: int = 1) -> AdamW:
    """AdamW with torch-default hyperparameters (betas 0.9/0.999, eps 1e-8,
    weight_decay 0.01), as the JAX package's ``make_optimizer``."""
    return AdamW(params, lr=lr, weight_decay=weight_decay, grad_clip=grad_clip, accum=accum)


@dataclass
class TrainState:
    """The model (updated in place), its optimizer, the number of steps
    taken and the seed of the training stream."""

    model: nn.Module
    optimizer: AdamW
    step: int = 0
    seed: int = 42


def create_train_state(model: nn.Module, seed: int = 42, lr: float = 1e-4,
                       weight_decay: float = 0.01, grad_clip: float = 0.0,
                       accum: int = 1,
                       device: str | torch.device | None = "cuda") -> TrainState:
    """The model moved to ``device`` (the CUDA device unless the caller
    passes ``device="cpu"``; raises without one) with a fresh optimizer."""
    model = model.to(resolve_device(device))
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), lr, weight_decay,
                                               grad_clip, accum),
                      step=0, seed=seed)


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one training step, on ``device``, seeded from
    (seed, step): the U-Net's dropout seed words and the posterior noise
    are drawn from it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    return gen
