"""Structured metric logging (port of ``probunet_tpu/train/logging.py``):
a JSONL sink, one line per logical event, an optional stdout echo, and
the wandb passthrough (``use_wandb=True``, ``train --wandb``) when the
library is importable; without it the logger quietly goes on, as the JAX
logger does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import numpy as np
import torch


def _to_scalar(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.dtype.kind in "biuf":
        return float(arr) if arr.size == 1 else arr.tolist()
    return v


class MetricLogger:
    def __init__(self, logdir: str | None = None, use_wandb: bool = False,
                 run_name: str = "run", stdout: bool = True):
        self.stdout = stdout
        self.path = None
        self._fh = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self.path = os.path.join(logdir, f"{run_name}.jsonl")
            self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                pass
        self.history: list[dict] = []

    def log(self, metrics: Mapping[str, Any], step: int | None = None,
            kind: str = "train"):
        rec = {"ts": time.time(), "kind": kind}
        if step is not None:
            rec["step"] = int(step)
        values = {k: _to_scalar(v) for k, v in metrics.items()}
        rec.update(values)
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(values, step=step)
        if self.stdout:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "ts")
            print(f"[{kind}] {body}")

    def close(self):
        if self._fh:
            self._fh.close()
