"""The harness: one run of one cell, driven by data.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``), a mode (``modes/<mode>.py``: the driver of one
kind of traffic's window) and the traffic's parameters. ``BENCHMARK.json``
says which end-to-end metrics a cell reports and which per-layer metrics
are read in its traced run; each per-layer metric is a reader of its own
(``metrics/<metric>.py``: ``read(trace) -> float | None``). Adding a
configuration, a cell or a metric therefore adds files and edits none.

A mode's ``run(run)`` builds the program's state, warms it at the cell's
shapes, runs the window inside ``run.window()`` and returns a
:class:`Outcome`; the harness times set-up, reads the device, checks that
no JAX module was loaded, reads the trace and prints the result line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "probunet_tpu")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    spec: dict          # BENCHMARK.json

    @property
    def mode(self) -> str:
        return self.workload["mode"]

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        return [m for m in self.spec["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = HERE, spec_path: Path | None = None) -> Cell:
    """The cell ``name`` from ``root``'s ``workloads/`` and ``configs/``."""
    spec = json.loads((spec_path or ROOT / "BENCHMARK.json").read_text())
    workload = json.loads((root / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / "configs" / f"{workload['config']}.json").read_text())
    return Cell(name, workload, config, spec)


def port_config(cell: Cell):
    """The program's configuration: the preset with every value of the
    configuration file set."""
    from probunet_tpu_torch.config import preset

    return preset(cell.config["preset"]).override(cell.config["values"])


def sizes(cell: Cell) -> dict:
    """The configuration's values by their last key, as the reference
    reads them."""
    return {k.rsplit(".", 1)[-1]: (tuple(v) if isinstance(v, list) else v)
            for k, v in cell.config["values"].items()}


def load_module(path: Path, name: str):
    """A mode or metric file as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclass
class Outcome:
    """What a mode hands back: the end-to-end values by metric name, the
    work attempted and failed, the units of work in the window
    (``{"steps": n}`` or ``{"batches": n}``), the numbers compared as
    (name, value, limit), and the facts the per-layer readers need."""

    end_to_end: dict
    attempted: int
    failed: int
    work: dict
    checks: list
    facts: dict = field(default_factory=dict)


class Spans:
    """Host spans of the harness's own calls into the program's layers:
    (name, start, end) on the host clock, those of the window and those of
    the traced segment apart."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.traced: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        (self.traced if self.profiling else self.spans).append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name)

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)


def seconds_since_start() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Run:
    """One run of a cell: its seed, window length, device and spans. The
    mode runs its measured loop inside :meth:`window`; in a traced run it
    then runs ``traced_units`` more units inside :meth:`traced`, which the
    profiler records (its overhead stays out of the window)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.spans = Spans()
        self.setup_s: float | None = None
        self.window_s: float | None = None
        self.traced_s: float | None = None
        self.profile = None
        self.mark = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; the device is
        synchronized before its end is read."""
        self.sync()
        self.setup_s = seconds_since_start()
        t0 = time.perf_counter()
        try:
            yield t0
            self.sync()
        finally:
            self.window_s = time.perf_counter() - t0

    @contextlib.contextmanager
    def traced(self):
        """The traced segment after the window (a traced run on the card
        only): the profiler records the CUDA runtime's launches and the
        device's activity (not the host's operators, whose recording
        would slow a step whose host work nearly matches the device's).
        A marker launch at a known host time places the harness's spans
        on the trace's clock."""
        if not (self.trace and self.device.type == "cuda"):
            yield False
            return
        self.sync()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        self.spans.profiling = True
        self.mark = time.perf_counter()
        torch.ones(1, device=self.device).add_(1.0)
        t0 = time.perf_counter()
        try:
            with self.spans("traced"):
                yield True
                self.sync()
        finally:
            self.traced_s = time.perf_counter() - t0
            self.spans.profiling = False
            prof.__exit__(None, None, None)
            self.profile = prof

    def elapsed(self, t0: float) -> bool:
        return time.perf_counter() - t0 >= self.seconds


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class Trace:
    """The traced window as the readers see it: device activities (kernel
    name, start, end, family, the harness span its launch fell in), the
    busy intervals' union, the window's length and the run's facts."""

    def __init__(self, run: Run, outcome: Outcome):
        from benchmark import counts

        self.run, self.outcome = run, outcome
        self.work = outcome.work
        self.facts = outcome.facts
        self.window_s = run.window_s
        self.traced_s = run.traced_s
        self.units = outcome.facts.get("traced_units", 0)
        self.spans = run.spans
        self.counts = counts
        self.kernels: list[tuple[str, int, int, str, str | None]] = []
        self.busy_s = 0.0
        self.gaps: list[tuple[int, int]] = []
        self.annotations: list[tuple[str, int, int]] = []
        if run.profile is not None:
            self._read(run.profile)

    def _read(self, prof) -> None:
        from benchmark import counts

        cuda = torch.autograd.DeviceType.CUDA
        launches, device, kernel_launches = {}, [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                device.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
            elif e.name().startswith(("cuda", "cu")):
                launches[e.correlation_id()] = e.start_ns()
                if e.name() == "cudaLaunchKernel":
                    kernel_launches.append(e.start_ns())
        if not kernel_launches:
            return
        # the marker is the segment's first kernel launch
        offset = min(kernel_launches) - int(self.run.mark * 1e9)
        notes = sorted(((n, int(a * 1e9) + offset, int(b * 1e9) + offset)
                        for n, a, b in self.spans.traced), key=lambda n: (n[1], -n[2]))
        w0, w1 = next((a, b) for n, a, b in notes if n == "traced")
        self.annotations = [n for n in notes if n[0] != "traced"]
        for name, a, b, corr in device:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            self.kernels.append((name, a, b, counts.family(name),
                                 self._span_at(launches.get(corr))))
        ivs = sorted((a, b) for _, a, b, _, _ in self.kernels)
        busy, cur, gaps, last = 0, None, [], w0
        for a, b in ivs:
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                if a > last:
                    gaps.append((last, a))
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
            last = max(last, b)
        if cur is not None:
            busy += cur[1] - cur[0]
        if w1 > last:
            gaps.append((last, w1))
        self.busy_s = busy * 1e-9
        self.gaps = gaps

    def _span_at(self, t: int | None) -> str | None:
        """The innermost harness span holding host time ``t``."""
        if t is None:
            return None
        found = None
        for name, a, b in self.annotations:
            if a > t:
                break
            if b >= t:
                found = name
        return found

    def family_s(self, *families: str) -> float:
        return sum(b - a for _, a, b, f, _ in self.kernels if f in families) * 1e-9

    def span_device_s(self, span: str) -> float | None:
        """Device seconds of the kernels launched inside ``span``, or None
        when no launch could be placed in a span."""
        if not any(s is not None for *_, s in self.kernels):
            return None
        return sum(b - a for _, a, b, _, s in self.kernels if s == span) * 1e-9

    def breakdown(self) -> dict:
        fam: dict[str, float] = {}
        other: dict[str, float] = {}
        for name, a, b, f, _ in self.kernels:
            fam[f] = fam.get(f, 0.0) + (b - a) * 1e-9
            if f == "other":
                other[name] = other.get(name, 0.0) + (b - a) * 1e-9
        ops = sorted(([f, s] for f, s in fam.items() if f != "other"), key=lambda r: -r[1])
        rest = sorted((["other: " + n[:80], s] for n, s in other.items()), key=lambda r: -r[1])
        ops = sorted(ops[:6] + rest[:10 - len(ops[:6])], key=lambda r: -r[1])
        gaps = sorted(([self._span_at(a) or "outside any span", (b - a) * 1e-9]
                       for a, b in self.gaps), key=lambda r: -r[1])[:10]
        return {"device_ops": ops, "idle_gaps": gaps}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "--id=0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def read_per_layer(cell: Cell, trace: Trace) -> dict:
    out = {}
    for m in cell.per_layer():
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: torch.device) -> tuple[Run, Outcome]:
    """Build and run the cell's mode; returns the run and its outcome."""
    mode = load_module(HERE / "modes" / f"{cell.mode}.py", "bench_mode_" + cell.mode)
    run = Run(cell, seed, seconds, trace, device)
    return run, mode.run(run)


def result_line(cell: Cell, run: Run, outcome: Outcome) -> dict:
    """The JSON object the run prints last."""
    dev = run.device
    checks = {n: {"value": v, "limit": lim} for n, v, lim in outcome.checks}
    correct = all(v <= lim for _, v, lim in outcome.checks) and outcome.failed == 0
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": outcome.facts.get("memory_peak_bytes", 0)}
    units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"]}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed}
    if run.trace:
        tr = Trace(run, outcome)
        line["metrics"] = read_per_layer(cell, tr)
        device.update(busy_s=tr.busy_s, window_s=run.traced_s)
        line["device"] = device
        line["breakdown"] = tr.breakdown()
    else:
        e2e = dict(outcome.end_to_end, setup_s=run.setup_s)
        line["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": units[m["name"]]}
                           for m in cell.end_to_end()}
        line["device"] = device
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    line["checks"] = checks
    return line


def main(args) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    want = next(w for w in cell.spec["workloads"] if w["name"] == cell.name)["chips"]
    if torch.cuda.device_count() < want:
        print(f"{cell.name} needs {want} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.benchmark = False
    run, outcome = execute(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, run, outcome)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

