"""Batch iteration (port of ``probunet_tpu/data/loader.py``).

:class:`Batches` is the JAX package's epoch index batching: numpy, with
shuffling from an explicit ``np.random.default_rng(seed)`` and drop-last
by default, so both packages visit the same items in the same order.
:func:`to_device` is a plain host-to-device copy; the JAX package's
double-buffered prefetch (pinned memory here) is not ported yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class Batches:
    """Iterate index batches over a dataset length (drop_last keeps every
    batch the same shape, as the reference's static batching does)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True):
        self.n = int(n)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        stop = (self.n // self.batch_size) * self.batch_size if self.drop_last else self.n
        for s in range(0, stop, self.batch_size):
            yield idx[s: s + self.batch_size]


def to_device(batch, device: torch.device) -> torch.Tensor:
    """A host batch (numpy array or tensor) as a tensor on ``device``."""
    return torch.as_tensor(batch).to(device)
