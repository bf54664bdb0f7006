"""Checkpoints of the train state (port of ``probunet_tpu/train/checkpoint.py``).

``torch.save`` of the model's ``state_dict``, the optimizer's state, the
step and the seed — everything an exact resume needs, since the step's
random numbers derive from (seed, step) — one file per step, keeping the
newest ``max_to_keep``; the schedule metadata (``extra``) as JSON beside
it; and a separate "best" slot for the early stopper's weights. Orbax is
not used.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

_NAME = re.compile(r"^state_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best = os.path.join(self.directory, "best_params.pt")

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"state_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def save(self, step: int, state, extra: dict[str, Any] | None = None):
        blob = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step), "seed": int(state.seed)}
        tmp = self._path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        if extra is not None:
            with open(os.path.join(self.directory, f"extra_{step}.json"), "w") as f:
                json.dump(extra, f)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
            extra_old = os.path.join(self.directory, f"extra_{old}.json")
            if os.path.exists(extra_old):
                os.remove(extra_old)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load ``step`` (default: the latest) into ``state`` in place;
        returns (state, extra), or (None, None) when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        dev = next(state.model.parameters()).device
        blob = torch.load(self._path(step), map_location=dev, weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step, state.seed = int(blob["step"]), int(blob["seed"])
        extra = None
        extra_path = os.path.join(self.directory, f"extra_{step}.json")
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return state, extra

    def save_best(self, params: Mapping[str, torch.Tensor]):
        torch.save(dict(params), self._best)

    def restore_best(self, device: str | torch.device = "cpu"):
        if not os.path.exists(self._best):
            return None
        return torch.load(self._best, map_location=device, weights_only=True)
