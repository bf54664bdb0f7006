"""Each mode runs a tiny cell on the CPU through the program's plain
versions and comes out correct against the reference; the cell is added
from files in a temporary directory, as a later cell would be."""

from __future__ import annotations

import math

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("mode", ["train", "evaluate"])
def test_tiny_cell_runs_correct(tiny, mode):
    root, spec = tiny
    run, out, line = run_tiny(root, spec, mode)
    assert line["correct"], line["checks"]
    assert out.attempted > 0 and out.failed == 0
    names = {m["name"] for m in run.cell.end_to_end()}
    assert set(line["metrics"]) == names
    assert all(math.isfinite(v["value"]) and v["value"] > 0
               for k, v in line["metrics"].items() if k != "peak_mem_gb")
    assert list(line)[-1] == "checks"
