"""Patience-based early stopping with best-weights restore (port of
``probunet_tpu/train/early_stop.py``).

Semantics of the reference ``EarlyStopper``
(reference src/train_prob_unet_model.py:76-102): on improvement, snapshot
the model as best and reset the counter; when validation loss exceeds
best + min_delta for `patience` consecutive checks, stop and restore the
best weights. The snapshot is a copy of the model's ``state_dict`` (cloned
tensors on their device), optionally persisted through the
CheckpointManager's best slot.
"""

from __future__ import annotations

from typing import Mapping

import torch


class EarlyStopper:
    def __init__(self, patience: int = 1, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = float("inf")
        self.best_params: dict[str, torch.Tensor] | None = None

    def early_stop(self, validation_loss: float,
                   params: Mapping[str, torch.Tensor]) -> tuple[bool, Mapping]:
        """Returns (should_stop, params_to_continue_with); on stop, the
        params are the best snapshot."""
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.best_params = {k: v.detach().clone() for k, v in params.items()}
            self.counter = 0
        elif validation_loss > (self.min_validation_loss + self.min_delta):
            self.counter += 1
            if self.counter >= self.patience:
                return True, self.best_params
        return False, params
