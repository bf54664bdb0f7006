"""Tracing and profiling hooks (port of ``probunet_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over the enclosed block (host, and the
  card when there is one), written into ``logdir`` as a Chrome trace
  (``chrome://tracing`` or ui.perfetto.dev);
- :func:`nan_check_mode`: autograd's anomaly detection, which names the
  forward operation whose backward produced a NaN;
- :func:`device_sync`: a host read of a value that depends on the work
  being timed;
- :class:`Throughput`: steps/s and samples/s with warm-up excluded;
- :func:`span`: the program's own host spans (``layer.what``) at its
  layer boundaries, kept in memory (:func:`spans`, :func:`clear`) while
  tracing is on: after ``enable(True)``, with ``PROBUNET_TRACE=1`` set at
  import, or while a ``torch.profiler`` session is active. Off, a span
  costs a check of two flags and returns a shared no-op context; on, two
  host clock reads and one append. A span never touches the device.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block into ``logdir/trace.json`` (Chrome trace
    format); yields the ``torch.profiler.profile`` object (its
    ``key_averages()`` sums time by operation and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def nan_check_mode(enable: bool = True):
    """Run the enclosed block with autograd's anomaly detection set to
    ``enable``: a backward that produces a NaN raises, naming the forward
    operation. The previous setting is restored on exit."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def device_sync(x: torch.Tensor) -> float:
    """The first element of ``x`` read on the host, after
    ``torch.cuda.synchronize()`` where ``x`` is on the card. Call it on a
    value produced by the work being timed: the read waits for the whole
    chain of work it depends on."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.detach().reshape(-1)[0])


class Throughput:
    """Steps/sec and samples/sec counter with warmup exclusion.

    NOTE: on async backends BOTH ends of the window need a true device sync
    (:func:`device_sync`). Without them the warmup tail (including compile)
    leaks into the measured window and the end may cover only dispatch. The
    honest pattern:

    >>> tp = Throughput(batch_size=32)
    >>> out = step(...); device_sync(out)     # warmup + compile, drained
    >>> tp.start()                            # timer starts at a quiesced device
    >>> for batch in batches: out = step(...); tp.step()
    >>> device_sync(out); tp.summary()

    The legacy mode (no ``start()``; the timer auto-starts at the
    ``step()`` where count reaches ``warmup_steps``) remains, but measures
    from host dispatch time of that step, not device completion.
    """

    def __init__(self, batch_size: int, warmup_steps: int = 2,
                 pixels_per_sample: int | None = None):
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self.pixels_per_sample = pixels_per_sample
        self.count = 0
        self._t0 = None

    def start(self):
        """Start the measured window NOW (call right after a device_sync on
        the last warmup step's output). Steps counted so far become warmup."""
        self._t0 = time.perf_counter()
        self._measured_from = self.count

    def step(self, n: int = 1):
        self.count += n
        if self._t0 is None and self.count >= self.warmup_steps:
            self._t0 = time.perf_counter()
            self._measured_from = self.count

    def summary(self) -> dict[str, float]:
        if self._t0 is None or self.count <= self._measured_from:
            return {"steps_per_sec": 0.0, "samples_per_sec": 0.0}
        dt = time.perf_counter() - self._t0
        steps = self.count - self._measured_from
        out = {
            "steps_per_sec": steps / dt,
            "samples_per_sec": steps * self.batch_size / dt,
        }
        if self.pixels_per_sample:
            out["pixels_per_sec"] = out["samples_per_sec"] * self.pixels_per_sample
        return out


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One closed span: ``start``/``end`` in ``time.perf_counter_ns()``;
    ``parent`` the ``id`` of the span open around it on its thread, or
    None."""

    id: int
    name: str
    start: int
    end: int
    parent: int | None
    thread: int


MAX_SPANS = 65536
_on = os.environ.get("PROBUNET_TRACE") == "1"
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_open = threading.local()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Record spans from now on (``on``), or only while a profiler runs."""
    global _on
    _on = bool(on)


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is recording (any activities)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context recording the enclosed host time as span ``name`` while
    tracing is on; the shared no-op context otherwise."""
    if not (_on or profiler_active()):
        return _OFF
    return _Recording(name)


class _Recording:
    __slots__ = ("id", "name", "start", "parent")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _open.stack.pop()
        _spans.append(Span(self.id, self.name, self.start, end, self.parent,
                           threading.get_ident()))
        return False


def spans() -> list[Span]:
    """The recorded spans, oldest first (the last ``MAX_SPANS``)."""
    return list(_spans)


def clear() -> None:
    """Forget every recorded span."""
    _spans.clear()
