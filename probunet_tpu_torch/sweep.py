"""Hyperparameter grid sweeps (port of ``probunet_tpu/sweep.py``).

Replacement for the reference's wandb grid sweep (reference sweeps.yaml:1-14,
which sweeps batch_size against val-loss). A sweep spec is a JSON/YAML-style
dict of dotted config keys to value lists; :func:`grid` expands the cross
product and :func:`run_sweep` trains each point with the Trainer, ranking by
final validation reconstruction.

    spec = {"train.batch_size": [16, 32, 64], "train.lr": [1e-4, 3e-4]}
    results = run_sweep(base_cfg, spec)   # 6 runs, best first

Each sweep point is an independent Config via ``Config.override`` — no
global state, so points can also be dispatched to separate hosts by index
(``grid(spec)[i]``).
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Sequence

import torch

from probunet_tpu_torch.config import Config


def grid(spec: dict[str, Sequence[Any]]) -> list[dict[str, Any]]:
    """Cross-product of a {dotted_key: [values...]} spec (wandb grid-method
    semantics, reference sweeps.yaml:4), the last key varying fastest."""
    keys = list(spec)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(spec[k] for k in keys))]


def run_sweep(
    base: Config,
    spec: dict[str, Sequence[Any]],
    metric: str = "val_crps",
    num_epochs: int | None = None,
    make_trainer=None,
    device: str | torch.device | None = "cuda",
) -> list[dict[str, Any]]:
    """Train every grid point, return [{overrides, metric, history}, ...]
    sorted best-first by the final value of ``metric`` (val-loss in the
    reference's sweep, sweeps.yaml:5-7); a point whose history lacks the
    metric ranks last.

    ``make_trainer(cfg) -> Trainer`` defaults to the CLI's construction
    (``cli.make_datasets`` train and validation splits, ``cli.make_model``)
    on ``device``: the CUDA device unless the caller passes ``"cpu"``.
    """
    if make_trainer is None:
        from probunet_tpu_torch.cli import make_datasets, make_model
        from probunet_tpu_torch.train.loop import Trainer

        def make_trainer(cfg):
            ds_train, ds_val, _ = make_datasets(cfg, splits=(0, 1), device=device)
            return Trainer(cfg, make_model(cfg, device), ds_train, ds_val, device=device)

    results = []
    for overrides in grid(spec):
        cfg = base.override(overrides)
        trainer = make_trainer(cfg)
        history = trainer.fit(num_epochs)
        final = history[metric][-1] if history.get(metric) else float("inf")
        results.append(
            {"overrides": overrides, metric: final, "history": history}
        )
        print(json.dumps({"sweep_point": overrides, metric: final}))
    results.sort(key=lambda r: r[metric])
    return results
