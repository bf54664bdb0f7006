"""The benchmark's own tests. Those marked ``card`` run on the card only
and skip elsewhere; whether a card is there is decided inside the
``card`` fixture, never at import."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_VALUES = {
    "data.variables": ["pr", "tasmin", "tasmax"], "data.resolution": [32, 32],
    "data.lowres_scale": 4, "data.pipeline": "lrinterp_to_residuals",
    "data.interp_mode": "nearest", "data.transfo": True, "data.standardization": "perpixel",
    "data.epsilon": 1e-10, "model.input_channels": 3, "model.num_classes": 3,
    "model.latent_dim": 4, "model.num_filters": [32, 16], "model.model_channels": 8,
    "model.channel_mult": [1, 2], "model.channel_mult_emb": 4, "model.num_blocks": 1,
    "model.dropout": 0.1, "model.label_dim": 1, "model.compute_dtype": "float32",
    "loss.loss_type": "afcrps", "loss.alpha": 0.95, "train.lr": 0.0001,
    "train.weight_decay": 0.01,
}
TINY_PARAMS = {
    "train": {"split_days": 40, "batch_size": 4, "members": 3, "beta_0": 1.0, "beta_1": 0.001,
              "prefetch": 2, "check_steps": 3, "reference_chunk": 2, "traced_units": 2},
    "evaluate": {"split_days": 40, "batch_size": 4, "members": 3, "warmup_batches": 1,
                 "checked_batches": 2, "traced_units": 2},
}
TINY_LIMITS = {"train": {"loss_gap": 1e-4, "kl_gap": 1e-3, "grad_gap": 1e-3, "change_gap": 1e-3},
               "evaluate": {"crps_gap": 1e-4, "mae_gap": 1e-4, "spread_gap": 1e-4,
                            "crps_mean_gap": 1e-5, "spread_mean_gap": 1e-5}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on a CUDA card only (skips elsewhere)")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(tmp_path):
    """(root, spec path) of the tiny cells written into a temporary
    directory."""
    return tmp_path, write_tiny_cells(tmp_path)


def run_tiny(root: Path, spec: Path, mode: str, seed: int = 2 ** 31 + 5, seconds: float = 0.5):
    """One run of the tiny cell of ``mode`` on the CPU: (run, outcome, line)."""
    from benchmark import harness

    cell = harness.load_cell(f"tiny_{mode}", root, spec)
    run, out = harness.execute(cell, seed, seconds, False, torch.device("cpu"))
    return run, out, harness.result_line(cell, run, out)


def write_tiny_cells(root: Path) -> Path:
    """A benchmark root with a tiny configuration and a train and an
    evaluate cell of it (``tiny_train``, ``tiny_evaluate``), and a spec
    naming them; returns the spec's path."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(
        {"preset": "probunet_multivar_128", "source": "test", "values": TINY_VALUES,
         "assumed": {}, "reduced": []}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for mode in ("train", "evaluate"):
        (root / "workloads" / f"tiny_{mode}.json").write_text(json.dumps(
            {"config": "tiny", "mode": mode, "traffic": f"tiny_{mode}",
             "params": TINY_PARAMS[mode], "limits": TINY_LIMITS[mode], "why": "test"}))
        spec["workloads"].append({"name": f"tiny_{mode}", "config": "tiny",
                                  "traffic": f"tiny_{mode}", "chips": 1, "why": "test"})
    serve = ("serve_member_fields_per_s", "serve_batch_ms_p95", "evaluate")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            on_serve = m["name"] in serve[:2] or m.get("moves") in serve[:2]
            m["workloads"].append("tiny_evaluate" if on_serve else "tiny_train")
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
