"""On the card: a traced run of the flagship's training cell reads every
kernel family its per-layer metrics read, so a renamed kernel fails here
instead of reading nothing. Run on the card's host:
``python3 -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import pytest


@pytest.mark.card
def test_traced_training_step_holds_every_family(card):
    from benchmark import harness

    cell = harness.load_cell("multivar128_train")
    run, out = harness.execute(cell, 2 ** 31 + 77, 1.0, True, card)
    trace = harness.Trace(run, out)
    families = {k[3] for k in trace.kernels}
    for fam in ("C fused_gn fwd", "C' fused_gn bwd", "A fcomb_crps fwd", "A' fcomb_crps bwd",
                "AdamW multi-tensor", "cuDNN/cuBLAS", "G window_mean", "other"):
        assert fam in families, fam
    values = harness.read_per_layer(cell, trace)
    assert set(values) == {m["name"] for m in cell.per_layer()}
    assert all(0 < v["value"] <= 100 for k, v in values.items() if v["unit"] == "%")
