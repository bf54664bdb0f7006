"""The program's own spans on the traced segment's clock, shared by the
per-layer metrics that read them.

The program records a span (``probunet_tpu_torch.utils.profiling.span``:
name, start and end on ``time.perf_counter_ns()``, the clock of the
harness's spans) at its layer boundaries while a profiler session is
active, so the harness's traced segment records them without any setting.
Here they are:

- kept where they fall inside the harness's ``traced`` span, on the host
  clock;
- placed on the trace's clock with the harness's own offset: the
  segment's first ``cudaLaunchKernel`` less ``run.mark`` (the marker
  launch's host time), as ``harness.Trace`` places its spans;
- charged with the device's work and idle time: each device activity to
  the innermost program span that holds its launch (the profile's runtime
  event of the same correlation id), each instant of each idle gap
  (``trace.gaps``) to the innermost program span that holds it, and the
  instants in no span to ``None`` (unspanned).

The offset is as good as the harness's: the marker's launch call starts a
few microseconds after ``run.mark`` is read, against gaps of milliseconds.
Where the program records no span (a checkout whose program has no span
recorder, or a run without a trace) :func:`read` gives None, and so does
every metric that reads it.
"""

from __future__ import annotations

import bisect
import weakref
from dataclasses import dataclass, field

_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclass
class ProgramSpans:
    """The traced segment's program spans and what was charged to them.

    ``spans``: (name, start, end) on the trace's clock, in ns; ``offset``:
    trace clock less host clock, in ns; ``idle_ns`` and ``launches``: by
    the innermost span's name, ``None`` for time or launches in no span."""

    offset: int
    spans: list[tuple[str, int, int]]
    idle_ns: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)

    def host_ns(self, name: str) -> int:
        return sum(b - a for n, a, b in self.spans if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


def _recorded() -> list | None:
    """The program's recorded spans, or None where it has no recorder."""
    try:
        from probunet_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def read(trace) -> ProgramSpans | None:
    """The program spans of ``trace``'s segment and their charges (computed
    once a trace), or None where no program span was recorded in it."""
    if trace in _cache:
        return _cache[trace]
    out = _read(trace)
    _cache[trace] = out
    return out


def _read(trace) -> ProgramSpans | None:
    import torch

    prof = trace.run.profile
    recorded = _recorded()
    if prof is None or not recorded:
        return None
    w = next(((a, b) for n, a, b in trace.spans.traced if n == "traced"), None)
    if w is None:
        return None
    h0, h1 = int(w[0] * 1e9), int(w[1] * 1e9)
    inside = [s for s in recorded if h0 <= s.start and s.end <= h1]
    if not inside:
        return None

    cuda = torch.autograd.DeviceType.CUDA
    launch_of, device, kernel_launches = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append(e.correlation_id())
        elif e.name().startswith(("cuda", "cu")):
            launch_of[e.correlation_id()] = (e.start_ns(), e.name())
            if e.name() == "cudaLaunchKernel":
                kernel_launches.append(e.start_ns())
    if not kernel_launches:
        return None
    offset = min(kernel_launches) - int(trace.run.mark * 1e9)
    spans = sorted(((s.name, s.start + offset, s.end + offset) for s in inside),
                   key=lambda s: (s[1], -s[2]))
    edges, owners = _segments(spans)
    out = ProgramSpans(offset, spans)

    for corr in device:
        launch = launch_of.get(corr)
        if launch is None or "Launch" not in launch[1]:
            continue
        owner = _owner(edges, owners, launch[0])
        out.launches[owner] = out.launches.get(owner, 0) + 1

    for a, b in trace.gaps:
        covered = 0
        i = max(bisect.bisect_right(edges, a) - 1, 0)
        while i < len(owners) and edges[i] < b:
            lo, hi = max(a, edges[i]), min(b, edges[i + 1])
            if hi > lo and owners[i] is not None:
                out.idle_ns[owners[i]] = out.idle_ns.get(owners[i], 0) + hi - lo
                covered += hi - lo
            i += 1
        out.idle_ns[None] = out.idle_ns.get(None, 0) + (b - a) - covered
    return out


def _segments(spans: list[tuple[str, int, int]]) -> tuple[list[int], list[str | None]]:
    """The spans' boundaries, sorted, and the name of the innermost span
    (the latest to open) over each interval between two neighbours."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    owners: list[str | None] = []
    for lo, hi in zip(edges, edges[1:]):
        best = None
        for name, a, b in spans:
            if a > lo:
                break
            if b >= hi:
                best = name
        owners.append(best)
    return edges, owners


def _owner(edges: list[int], owners: list[str | None], t: int) -> str | None:
    """The innermost span holding instant ``t``."""
    i = bisect.bisect_right(edges, t) - 1
    return owners[i] if 0 <= i < len(owners) else None


def host_ms(trace, unit: str, name: str) -> float | None:
    """Host ms a unit (``"steps"`` or ``"batches"``) in spans ``name``."""
    spans = read(trace)
    return None if spans is None else _per_unit(trace, unit, spans.host_ns(name) * 1e-6)


def idle_ms(trace, unit: str, name: str) -> float | None:
    """Device idle ms a unit charged to spans ``name``."""
    spans = read(trace)
    return None if spans is None else _per_unit(trace, unit,
                                                spans.idle_ns.get(name, 0) * 1e-6)


def launches(trace, unit: str, name: str) -> float | None:
    """Kernels a unit launched inside spans ``name``."""
    spans = read(trace)
    return None if spans is None else _per_unit(trace, unit, spans.launches.get(name, 0))


def _per_unit(trace, unit: str, value: float) -> float | None:
    """``value`` a step or batch of the traced segment, where the cell's
    units are ``unit``."""
    if unit not in trace.work or not trace.units:
        return None
    return value / trace.units
