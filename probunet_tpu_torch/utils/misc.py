"""Small training utilities (port of ``probunet_tpu/utils/misc.py``;
reference src/prob_unet_utils.py:26-43)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(params):
    if isinstance(params, nn.Module):
        yield from params.parameters()
    elif isinstance(params, Mapping):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, torch.Tensor):
        yield params
    else:
        for v in params:
            yield from _leaves(v)


def l2_regularization(params) -> torch.Tensor:
    """Sum of squared parameters (reference ``l2_regularisation``,
    src/prob_unet_utils.py:26-33) of a module's parameters, a (nested) dict
    of tensors or an iterable of tensors. Provided for explicit-penalty
    experiments; the default optimizer applies decoupled AdamW decay
    instead (train.state.make_optimizer)."""
    return sum((p * p).sum() for p in _leaves(params))


def moving_average(values, window: int = 20) -> np.ndarray:
    """Simple trailing moving average for loss-curve smoothing
    (reference ``moving_average``, src/prob_unet_utils.py:36-43, used by the
    deterministic training script's loss plots at
    src/deterministic_unet_main.py:94-108)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size < window:
        return v.copy()
    c = np.cumsum(np.insert(v, 0, 0.0))
    return (c[window:] - c[:-window]) / window
