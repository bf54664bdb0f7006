"""The benchmark's files: every configuration, cell and metric that
``BENCHMARK.json`` names exists and loads, and names only what exists."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for group in (SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]):
        assert len({e["name"] for e in group}) == len(group)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[k]:
            assert NAME.match(e["name"]), e["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert (ROOT / SPEC["command"][1]).is_file() and SPEC["paths"] == ["benchmark"]


@pytest.mark.parametrize("cfg", [c["name"] for c in SPEC["configs"]])
def test_config_file_loads_and_builds(cfg):
    from benchmark import harness
    from benchmark.reference.model import ProbUNet

    entry = next(c for c in SPEC["configs"] if c["name"] == cfg)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    cell = harness.Cell("x", {"params": {}}, data, SPEC)
    port = harness.port_config(cell)
    for key, value in data["values"].items():
        section, field = key.split(".")
        got = getattr(getattr(port, section), field)
        assert (list(got) if isinstance(got, tuple) else got) == value, key
    ProbUNet(harness.sizes(cell))


@pytest.mark.parametrize("w", [w["name"] for w in SPEC["workloads"]])
def test_workload_names_what_exists(w):
    from benchmark import harness

    cell = harness.load_cell(w)
    entry = next(e for e in SPEC["workloads"] if e["name"] == w)
    assert cell.workload["config"] == entry["config"]
    assert cell.workload["traffic"] == entry["traffic"] and entry["chips"] == 1
    assert (BENCH / "modes" / f"{cell.mode}.py").is_file()
    assert cell.end_to_end() and cell.per_layer()
    assert all(isinstance(v, float) and v > 0 for v in cell.limits.values())
    for m in cell.end_to_end() + cell.per_layer():
        assert "workloads" not in m or w in m["workloads"]


@pytest.mark.parametrize("m", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_exists(m):
    from benchmark import harness

    entry = next(e for e in SPEC["per_layer"] if e["name"] == m)
    mod = harness.load_module(BENCH / "metrics" / f"{m}.py", "t_" + m.replace(".", "_"))
    assert callable(mod.read)
    assert entry["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    movers = next(e for e in SPEC["end_to_end"] if e["name"] == entry["moves"])
    assert set(entry["workloads"]) <= set(movers.get("workloads", entry["workloads"]))
