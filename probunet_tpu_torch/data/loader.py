"""Batch iteration and the host-to-device prefetch (port of
``probunet_tpu/data/loader.py``).

:class:`Batches` is the JAX package's epoch index batching: numpy, with
shuffling from an explicit ``np.random.default_rng(seed)`` and drop-last
by default, so both packages visit the same items in the same order.

:func:`prefetch_to_device` keeps ``size`` batches in flight ahead of the
consumer. On a CUDA device each host batch is copied into pinned memory
and its ``non_blocking`` copy starts on a side stream; the consumer's
stream waits on that copy's event before it gets the tensor, and the
tensor is recorded on the consumer's stream so the caching allocator
does not hand its memory out early. A pinned buffer is written again only
after its copy has finished. There is no synchronous route on a CUDA
device. On the CPU it passes the batches through as tensors. The JAX
function's ``sharding`` argument belongs to the parallel paths, which are
not ported.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.utils.profiling import span


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


class _PinnedSlot:
    """One pinned host buffer and the event of the copy that last read it."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.copied: torch.cuda.Event | None = None

    def fill(self, host: torch.Tensor) -> torch.Tensor:
        with span("data.pin"):
            if self.copied is not None:
                self.copied.synchronize()   # its last copy has read the buffer
            if self.buf is None or self.buf.shape != host.shape or self.buf.dtype != host.dtype:
                self.buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            self.buf.copy_(host)
            return self.buf


def prefetch_to_device(iterable: Iterable, size: int = 2,
                       device: str | torch.device | None = "cuda") -> Iterator[torch.Tensor]:
    """Yield the host batches of ``iterable`` (numpy arrays or CPU tensors)
    as tensors on ``device`` (the CUDA device unless the caller passes
    ``device="cpu"``; raises without one), the copies of the next ``size``
    batches in flight while the consumer works on the current one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterable:
            yield torch.as_tensor(batch).to(dev)
        return
    stream = torch.cuda.Stream(dev)
    slots = [_PinnedSlot() for _ in range(size + 1)]
    queue: collections.deque = collections.deque()
    it = iter(iterable)
    count = itertools.count()

    def put(batch):
        slot = slots[next(count) % len(slots)]
        pinned = slot.fill(torch.as_tensor(batch))
        with torch.cuda.stream(stream):
            out = torch.empty(pinned.shape, dtype=pinned.dtype, device=dev)
            out.copy_(pinned, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(stream)
        return out, slot.copied

    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        out, copied = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(copied)
        out.record_stream(consumer)
        yield out
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
