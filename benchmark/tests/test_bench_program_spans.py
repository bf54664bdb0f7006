"""``benchmark/program_spans.py`` on a synthetic profile: the program's
spans are placed on the trace's clock with the harness's own offset, a
kernel is charged to the span that held its launch, an idle gap across
two spans is split between them, and nothing is read where the program
recorded no span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT

OFFSET = 7_000_000_123          # trace clock less host clock, ns
MARK = 10.0                     # host seconds of the marker launch


class _Event:
    def __init__(self, name, start, end, corr, device=False):
        self._v = (name, start, end, corr)
        self._device = device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU


def _ns(host_s: float) -> int:
    """Host seconds on the trace's clock."""
    return int(host_s * 1e9) + OFFSET


def _profile():
    """Runtime calls at host times, each with its device activity."""
    calls = [  # (runtime call, launched at, runs from, to)
        ("cudaLaunchKernel", MARK, MARK + 5e-6, MARK + 6e-6),             # the marker
        ("cudaLaunchKernel", 10.010, 10.011, 10.029),                     # in the forward
        ("cudaLaunchKernel", 10.052, 10.053, 10.054),                     # in the optimizer
        ("cudaLaunchKernelExC", 10.055, 10.0555, 10.0565),                # in the optimizer
        ("cudaMemcpyAsync", 10.056, 10.0566, 10.0570),                    # a copy, no kernel
        ("cudaLaunchKernel", 10.065, 10.066, 10.099),                     # in no program span
    ]
    events = []
    for corr, (call, at, a, b) in enumerate(calls, 1):
        events.append(_Event(call, _ns(at), _ns(at) + 2000, corr))
        events.append(_Event("kernel_%d" % corr, _ns(a), _ns(b), corr, device=True))
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _trace(monkeypatch, program):
    from benchmark import harness
    from probunet_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: program)
    spans = harness.Spans()
    spans.traced = [("step", 10.00002, 10.06), ("loader", 10.061, 10.064),
                    ("traced", 10.000010, 10.100)]
    run = SimpleNamespace(profile=_profile(), mark=MARK, spans=spans, window_s=1.0,
                          traced_s=0.09999)
    outcome = harness.Outcome(end_to_end={}, attempted=1, failed=0, work={"steps": 5},
                              checks=[], facts={"traced_units": 1})
    return harness.Trace(run, outcome)


def _program():
    from probunet_tpu_torch.utils.profiling import Span

    host = [("train.forward", 10.00003, 10.030), ("train.backward", 10.030, 10.050),
            ("train.optimizer", 10.050, 10.058), ("data.gather", 10.0615, 10.0625),
            ("train.forward", 10.2, 10.3)]          # after the segment: left out
    return [Span(i, n, int(a * 1e9), int(b * 1e9), None, 1) for i, (n, a, b) in enumerate(host)]


def test_offset_launches_and_split_gaps(monkeypatch):
    from benchmark import harness, program_spans

    trace = _trace(monkeypatch, _program())
    got = program_spans.read(trace)
    step = next(a for n, a, _ in trace.annotations if n == "step")
    assert got.offset == OFFSET == step - int(10.00002 * 1e9)
    assert [s[0] for s in got.spans] == ["train.forward", "train.backward", "train.optimizer",
                                         "data.gather"]
    assert got.launches == {None: 2, "train.forward": 1, "train.optimizer": 2}
    # the forward holds the segment's first gap from its start and 1 ms of
    # the gap that runs on through the backward (all 20 ms) into the
    # optimizer (3 ms, and 2.6 ms more between and after its activities)
    assert got.idle_ns["train.forward"] == pytest.approx(10.97e6 + 1e6, abs=5)
    assert got.idle_ns["train.backward"] == pytest.approx(20e6, abs=5)
    assert got.idle_ns["train.optimizer"] == pytest.approx(5.6e6, abs=5)
    assert got.idle_ns["data.gather"] == pytest.approx(1e6, abs=5)
    assert sum(got.idle_ns.values()) == sum(b - a for a, b in trace.gaps)
    assert program_spans.read(trace) is got

    def metric(name):
        return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                                   "t_" + name.replace(".", "_")).read(trace)

    assert metric("backward_host_ms.train") == pytest.approx(20.0, abs=1e-5)
    assert metric("backward_idle_ms.train") == pytest.approx(20.0, abs=1e-5)
    assert metric("optimizer_launches.train") == 2
    assert metric("gather_host_ms.train") == pytest.approx(1.0, abs=1e-5)
    assert metric("gather_host_ms.serve") is None        # a training trace


@pytest.mark.parametrize("program", [[], None])
def test_nothing_read_without_program_spans(monkeypatch, program):
    from benchmark import harness, program_spans
    from probunet_tpu_torch.utils import profiling

    trace = _trace(monkeypatch, program or [])
    if program is None:                 # a program without a span recorder
        monkeypatch.delattr(profiling, "spans")
    assert program_spans.read(trace) is None
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / "forward_host_ms.train.py",
                              "t_forward_host")
    assert mod.read(trace) is None
