"""Training: the train state and AdamW, the beta schedule, early stopping,
the ELBO, eval and deterministic steps, the epoch loop and ``Trainer``,
checkpoints and metric logging; the EDM diffusion loss, train step, Heun
sampler and ensembles."""

from probunet_tpu_torch.train.state import TrainState, create_train_state
from probunet_tpu_torch.train.schedule import beta_schedule
from probunet_tpu_torch.train.early_stop import EarlyStopper
from probunet_tpu_torch.train.loop import (
    make_train_step,
    make_eval_step,
    make_deterministic_train_step,
    train_epoch,
    eval_model,
    Trainer,
)
from probunet_tpu_torch.train.checkpoint import CheckpointManager
from probunet_tpu_torch.train.logging import MetricLogger
from probunet_tpu_torch.train.edm import (
    edm_loss,
    make_edm_train_step,
    edm_sample,
    edm_ensemble,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "beta_schedule",
    "EarlyStopper",
    "make_train_step",
    "make_eval_step",
    "make_deterministic_train_step",
    "train_epoch",
    "eval_model",
    "Trainer",
    "CheckpointManager",
    "MetricLogger",
    "edm_loss",
    "make_edm_train_step",
    "edm_sample",
    "edm_ensemble",
]
