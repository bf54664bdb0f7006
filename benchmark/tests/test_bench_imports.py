"""What a run loads: no module of JAX, Flax or the JAX package (top-level
names compared whole), and the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "probunet_tpu")


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=600).stdout
    return {m.split(".", 1)[0] for m in json.loads(out.strip().splitlines()[-1])}


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r}); sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from conftest import write_tiny_cells, run_tiny
root = Path({str(tmp_path)!r}); spec = write_tiny_cells(root)
for mode in ("train", "evaluate"):
    run_tiny(root, spec, mode, seconds=0.2)
from benchmark import harness
import benchmark.calibrate
print(json.dumps(sorted(sys.modules)))
"""
    tops = _loaded(code)
    assert not tops & set(FORBIDDEN)
    assert "probunet_tpu_torch" in tops and "benchmark" in tops


def test_the_reference_loads_no_program():
    code = """
import sys, json
from benchmark.reference import model, data, masks
from benchmark import counts, weights, synth
print(json.dumps(sorted(sys.modules)))
"""
    tops = _loaded(code)
    assert not tops & set(FORBIDDEN + ("probunet_tpu_torch",))
