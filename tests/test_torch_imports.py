"""The port imports without JAX and without the JAX package: the machine
with the GPU has no JAX, and the port keeps its own copy of what it needs.

A fresh interpreter blocks ``jax``, ``flax`` and ``probunet_tpu``
(``sys.modules[name] = None`` makes every import of them fail), then
imports every module of ``probunet_tpu_torch`` and ``chip_smoke`` (the
import only, not its run); none of them may load matplotlib, PyYAML or
wandb either (the card's host may not have them: figures import
matplotlib when they are drawn, ``sweep`` PyYAML when it reads a YAML
spec, the logger wandb when asked to log there). The
port's config copy must equal the JAX package's, preset by preset.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["probunet_tpu"] = None
import probunet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(probunet_tpu_torch.__path__,
                                               "probunet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "probunet_tpu", "matplotlib",
                                       "yaml", "wandb")
                and sys.modules[m] is not None)
print(json.dumps({"names": names, "loaded": loaded}))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["names"]) >= 20
    # every kernel module, the GroupNorm chain's (C, C′) included
    for kernel in ("afcrps", "fcomb_crps", "fused_gn", "dropout", "int8_conv", "avg_pool",
                   "_build"):
        assert f"probunet_tpu_torch.ops.kernels.{kernel}" in res["names"], kernel
    for name in ("cli", "__main__", "data.climex", "evals.gev", "evals.histograms",
                 "evals.metrics", "utils.plotting", "ops.quantize", "parallel.spatial",
                 "bench", "sweep", "data.eda", "data.synthetic", "utils.profiling",
                 "utils.misc", "parallel.mesh", "parallel.multihost",
                 "parallel.data_parallel", "parallel.member_parallel",
                 "parallel.tensor_parallel"):
        assert f"probunet_tpu_torch.{name}" in res["names"], name
    assert res["loaded"] == []


def test_no_jax_import_statement_in_the_port():
    """No ``import jax`` / ``from flax ...`` / ``import probunet_tpu...`` /
    ``from probunet_tpu... import`` anywhere in the package or in
    chip_smoke.py, even inside a function."""
    files = sorted((REPO / "probunet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {r}" for r in roots
                          if r in ("jax", "jaxlib", "flax", "probunet_tpu")]
    assert not offenders


def test_config_copy_matches_the_jax_presets():
    from probunet_tpu import config as jax_config

    from probunet_tpu_torch import config

    assert config.PRESETS == jax_config.PRESETS
    for name in config.PRESETS:
        assert config.preset(name).to_dict() == jax_config.preset(name).to_dict(), name
    assert config.Config().to_dict() == jax_config.Config().to_dict()
    over = {"train.lr": 3e-4, "model.channel_mult": [1, 2]}
    assert (config.Config().override(over).to_dict()
            == jax_config.Config().override(over).to_dict())
