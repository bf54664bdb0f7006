"""On the card: in a traced step of the flagship's training cell the
program's own spans are recorded, every training metric that reads them
reads a number, and the idle time charged to them and to no span is the
traced segment's idle time. Run on the card's host:
``python3 -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import pytest

TRAIN_SPAN_METRICS = ("forward_host_ms.train", "backward_host_ms.train",
                      "optimizer_host_ms.train", "forward_idle_ms.train",
                      "backward_idle_ms.train", "optimizer_idle_ms.train",
                      "optimizer_launches.train", "gather_host_ms.train", "pin_host_ms.train")


@pytest.mark.card
def test_traced_training_step_reads_the_program_spans(card):
    from benchmark import harness, program_spans

    cell = harness.load_cell("multivar128_train")
    run, out = harness.execute(cell, 2 ** 31 + 79, 1.0, True, card)
    trace = harness.Trace(run, out)
    values = harness.read_per_layer(cell, trace)
    for name in TRAIN_SPAN_METRICS:
        assert name in values, name
        assert values[name]["value"] >= 0, name
    for name in ("forward_host_ms.train", "backward_host_ms.train",
                 "optimizer_host_ms.train", "gather_host_ms.train",
                 "optimizer_launches.train"):
        assert values[name]["value"] > 0, name
    spans = program_spans.read(trace)
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert spans.count(name) == trace.units, name
    idle = trace.traced_s - trace.busy_s
    assert sum(spans.idle_ns.values()) * 1e-9 == pytest.approx(idle, rel=0.01)
