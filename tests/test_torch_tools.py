"""The port's tools against the JAX package's: sweeps (``sweep.py`` and the
``sweep`` subcommand), profiling hooks, the small training utilities, the
last two figures (``plot_batch``, ``plot_seasonal_maps``) and the wandb
hook of ``MetricLogger``.

- Sweeps: the grid order and the best-first ranking equal JAX's
  (``grid``, ``run_sweep`` with a trainer whose history is a function of
  the point); the spec the ``sweep`` subcommand reads from ``--grid``, a
  JSON ``--spec`` and a wandb-style YAML ``--spec`` equals the one the JAX
  subcommand hands its ``run_sweep``, and both write the same
  ``sweep.json`` and ``{"best", "points"}`` line for the same results;
  ``sweep --grid`` and the YAML spec train for real on the tiny overrides
  of ``tests/test_cli.py`` (its assertions, JAX ``test_cli.py:137``,
  ``:151``).
- ``Throughput`` equals JAX's summaries on a shared fake clock;
  ``l2_regularization`` and ``moving_average`` equal JAX's on the same
  inputs (JAX ``test_utils.py:11-52``).
- The figures hold the JAX figures' panels array for array.
- ``train --wandb`` runs where wandb is absent; where it is present the
  logger hands it the same values and steps as the JAX logger.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch import cli as tcli
from probunet_tpu_torch import sweep as tsweep
from probunet_tpu_torch.config import preset

pytestmark = pytest.mark.usefixtures("torch_one_thread")

PRESET = "probunet_latent6_64"
TINY = [
    "--set",
    'data.resolution=[16,16]', 'data.coords=[0,16,0,16]',
    "data.lowres_scale=4",
    'data.years_train=[1960,1961]', 'data.years_val=[1961,1962]',
    'data.years_test=[1962,1963]',
    'model.num_filters=[8,16]', "model.model_channels=8",
    'model.channel_mult=[1,2]', "model.num_blocks=1", "model.latent_dim=4",
]
YAML_SPEC = ("program: main.py\nmethod: grid\nmetric:\n  name: val-loss\n  goal: minimize\n"
             "parameters:\n  batch_size:\n    values: [16, 32]\n  lr:\n    values: [0.001]\n")


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv("PROBUNET_PLATFORM", "cpu")


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

SPECS = [{"train.lr": [1e-3, 1e-4]},
         {"train.batch_size": [16, 32, 64], "train.lr": [1e-4, 3e-4], "model.latent_dim": [4]},
         {"a": [], "b": [1, 2]}]


@pytest.mark.parametrize("spec", SPECS, ids=["one", "three", "empty"])
def test_grid_order_matches_jax(spec):
    from probunet_tpu.sweep import grid as jax_grid

    assert tsweep.grid(spec) == jax_grid(spec)


class _FakeTrainer:
    """A trainer whose validation history is a function of its point (the
    last point has no ``val_crps``: it ranks last)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def fit(self, num_epochs=None):
        lr, bs = self.cfg.train.lr, self.cfg.train.batch_size
        if bs == 64 and lr == 3e-4:
            return {"val_crps": []}
        n = num_epochs or self.cfg.train.num_epochs
        return {"val_crps": [abs(np.log10(lr) + 3.7) + bs / 100.0 + k for k in range(n, 0, -1)]}


def test_run_sweep_ranking_matches_jax(capsys):
    from probunet_tpu.config import preset as jax_preset
    from probunet_tpu.sweep import run_sweep as jax_run_sweep

    spec = SPECS[1]
    got = tsweep.run_sweep(preset(PRESET), spec, num_epochs=2, make_trainer=_FakeTrainer)
    lines_port = capsys.readouterr().out
    want = jax_run_sweep(jax_preset(PRESET), spec, num_epochs=2, make_trainer=_FakeTrainer)
    assert lines_port == capsys.readouterr().out
    assert [(r["overrides"], r["val_crps"]) for r in got] == \
        [(r["overrides"], r["val_crps"]) for r in want]
    assert got[-1]["val_crps"] == float("inf") and len(got) == 6
    assert [r["history"] for r in got] == [r["history"] for r in want]


def _spec_file(tmp_path, kind):
    if kind == "json":
        path = tmp_path / "spec.json"
        path.write_text(json.dumps({"train.lr": [0.001, 0.0001], "model.latent_dim": [4]}))
    else:
        path = tmp_path / "sweeps.yaml"
        path.write_text(YAML_SPEC)
    return ["--spec", str(path)]


@pytest.mark.parametrize("kind", ["grid", "json", "yaml"])
def test_sweep_command_matches_jax(tmp_path, monkeypatch, capsys, on_cpu, kind):
    """The JAX and port subcommands read the same spec and, for the same
    results, write the same ``sweep.json`` and print the same line."""
    import probunet_tpu.cli as jax_cli
    import probunet_tpu.sweep as jax_sweep

    flags = (["--grid", "train.lr=0.001,0.0001", "data.pipeline=lr_to_residuals,x"]
             if kind == "grid" else _spec_file(tmp_path, kind))
    seen = {}

    def fake(pkg):
        def run_sweep(cfg, spec, metric="val_crps", num_epochs=None, **kw):
            seen[pkg] = (spec, metric, num_epochs)
            pts = (tsweep if pkg == "port" else jax_sweep).grid(spec)
            return [{"overrides": o, metric: float(i)} for i, o in enumerate(pts)]
        return run_sweep

    monkeypatch.setattr(jax_sweep, "run_sweep", fake("jax"))
    monkeypatch.setattr(tsweep, "run_sweep", fake("port"))
    argv = ["sweep", "--preset", PRESET, "--metric", "val_kl", "--epochs", "3"] + flags
    jax_cli.main(argv + ["--outdir", str(tmp_path / "jax")] + TINY)
    jax_line = capsys.readouterr().out
    tcli.main(argv + ["--outdir", str(tmp_path / "port")] + TINY)
    assert capsys.readouterr().out == jax_line
    assert seen["port"] == seen["jax"] and seen["port"][1:] == ("val_kl", 3)
    if kind == "yaml":
        assert seen["port"][0] == {"train.batch_size": [16, 32], "train.lr": [0.001]}
    for name in ("jax", "port"):
        with open(tmp_path / name / "sweep.json") as f:
            seen[name] = json.load(f)
    assert seen["port"] == seen["jax"]


def test_sweep_yaml_without_pyyaml(tmp_path, monkeypatch, on_cpu):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(SystemExit, match="PyYAML"):
        tcli.main(["sweep", "--preset", PRESET, "--outdir", str(tmp_path)]
                  + _spec_file(tmp_path, "yaml") + TINY)
    with pytest.raises(SystemExit, match="--grid"):
        tcli.main(["sweep", "--preset", PRESET, "--outdir", str(tmp_path)] + TINY)


@pytest.mark.parametrize("kind", ["grid", "yaml"])
def test_sweep_trains_each_point(tmp_path, capsys, on_cpu, kind):
    """JAX ``test_cli.py:137`` and ``:151`` on the port: one epoch per
    point, the points in grid order, ``sweep.json`` best first."""
    flags = (["--grid", "train.lr=0.001,0.0001"] if kind == "grid"
             else _spec_file(tmp_path, "yaml"))
    out = str(tmp_path / "sweep")
    summary = tcli.main(["sweep", "--preset", PRESET, "--outdir", out, "--epochs", "1"]
                        + flags + TINY)
    printed = capsys.readouterr().out
    res = json.loads([ln for ln in printed.splitlines() if '"best"' in ln][-1])
    key = "train.lr" if kind == "grid" else "train.batch_size"
    assert res["points"] == 2 and key in res["best"]["overrides"]
    points = [json.loads(ln)["sweep_point"] for ln in printed.splitlines()
              if ln.startswith('{"sweep_point"')]
    values = [0.001, 0.0001] if kind == "grid" else [16, 32]
    assert [p[key] for p in points] == values
    with open(os.path.join(out, "sweep.json")) as f:
        written = json.load(f)
    assert written == summary and len(written) == 2
    scores = [r["val_crps"] for r in written]
    assert scores == sorted(scores) and all(np.isfinite(scores))


# ---------------------------------------------------------------------------
# profiling and misc
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _throughput_runs(cls):
    """Summaries of the same call sequences on a fresh fake clock."""
    import time

    out = []
    real = time.perf_counter
    time.perf_counter = _Clock()
    try:
        tp = cls(batch_size=4, warmup_steps=1)
        for _ in range(5):
            tp.step()
        out.append(tp.summary())
        tp = cls(batch_size=8, warmup_steps=2, pixels_per_sample=16)
        tp.step(3)
        tp.start()
        for _ in range(4):
            tp.step(2)
        out.append(tp.summary())
        out.append(cls(batch_size=2).summary())
    finally:
        time.perf_counter = real
    return out


def test_throughput_matches_jax():
    from probunet_tpu.utils.profiling import Throughput as JaxThroughput

    from probunet_tpu_torch.utils.profiling import Throughput

    got = _throughput_runs(Throughput)
    assert got == _throughput_runs(JaxThroughput)
    assert got[0]["samples_per_sec"] == got[0]["steps_per_sec"] * 4 > 0
    assert got[1]["pixels_per_sec"] == got[1]["samples_per_sec"] * 16
    assert got[2] == {"steps_per_sec": 0.0, "samples_per_sec": 0.0}


def test_nan_check_mode_and_device_sync():
    from probunet_tpu.utils.profiling import device_sync as jax_device_sync

    from probunet_tpu_torch.utils.profiling import device_sync, nan_check_mode

    before = torch.is_anomaly_enabled()
    with nan_check_mode(True):
        assert torch.is_anomaly_enabled()
        with nan_check_mode(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
        x = torch.tensor(-1.0, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            x.sqrt().backward()
    assert torch.is_anomaly_enabled() == before
    a = np.array([[3.5, -1.0], [2.0, 7.0]], np.float32)
    assert device_sync(torch.from_numpy(a)) == jax_device_sync(a) == 3.5


def test_trace_writes_a_chrome_trace(tmp_path):
    from probunet_tpu_torch.utils.profiling import trace

    logdir = tmp_path / "prof"
    with trace(str(logdir)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert any("mm" in row.key for row in prof.key_averages())


def test_misc_utils_match_jax():
    import jax.numpy as jnp

    from probunet_tpu.utils import l2_regularization as jax_l2
    from probunet_tpu.utils import moving_average as jax_ma

    from probunet_tpu_torch.utils import l2_regularization, moving_average

    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(4).astype(np.float32),
                  "d": rng.standard_normal((3, 1, 2)).astype(np.float32)}}
    want = float(jax_l2({"a": jnp.asarray(tree["a"]),
                         "b": {k: jnp.asarray(v) for k, v in tree["b"].items()}}))
    got = l2_regularization({"a": torch.from_numpy(tree["a"]),
                             "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    ones = {"a": torch.ones(2, 3), "b": {"c": 2.0 * torch.ones(4)}}
    assert float(l2_regularization(ones)) == 6 + 16
    lin = torch.nn.Linear(3, 2)
    assert torch.equal(l2_regularization(lin), (lin.weight ** 2).sum() + (lin.bias ** 2).sum())
    for values, window in ((rng.standard_normal(50), 7), (np.arange(10.0), 4),
                           ([1.0, 2.0], 4), (rng.standard_normal(20), 20)):
        np.testing.assert_array_equal(moving_average(values, window), jax_ma(values, window))
    np.testing.assert_allclose(moving_average(np.arange(10.0), 4),
                               [1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5])


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def _panels(fig):
    """(suptitle, [(ylabel, title, [panel arrays])] per axes) of a figure."""
    rows = []
    for ax in fig.axes:
        arrays = [np.asarray(im.get_array()) for im in list(ax.images) + list(ax.collections)]
        rows.append((ax.get_ylabel(), ax.get_title(), arrays))
    return fig.get_suptitle(), rows


def _assert_same_figure(got, want):
    (gs, grows), (ws, wrows) = _panels(got), _panels(want)
    assert gs == ws and len(grows) == len(wrows)
    for (gy, gt, ga), (wy, wt, wa) in zip(grows, wrows):
        assert (gy, gt, len(ga)) == (wy, wt, len(wa))
        for a, b in zip(ga, wa):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("geo", [False, True], ids=["index", "latlon"])
def test_plot_batch_matches_jax(tmp_path, geo):
    import matplotlib.pyplot as plt

    from probunet_tpu.utils.plotting import plot_batch as jax_plot_batch

    from probunet_tpu_torch.utils.plotting import plot_batch

    rng = np.random.default_rng(2)
    b, h, w, c = 2, 8, 8, 3
    lr = rng.standard_normal((b, 4, 4, c)).astype(np.float32)
    hr = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pred = rng.standard_normal((b, h, w, c)).astype(np.float32)
    coords = {}
    if geo:
        coords = {"lat": np.linspace(44.0, 46.0, h)[:, None] + np.zeros((1, w)),
                  "lon": np.zeros((h, 1)) + np.linspace(-75.0, -72.0, w)[None, :]}
    got = plot_batch(lr, pred, hr, timestamps=["d0", "d1"], **coords)
    want = jax_plot_batch(lr, pred, hr, timestamps=["d0", "d1"], **coords)
    assert list(got) == list(want) == ["pr", "tasmin", "tasmax"]
    for var in got:
        _assert_same_figure(got[var], want[var])
    plt.close("all")
    plot_batch(lr, pred, hr, save_path=str(tmp_path / "b.png"), **coords)
    for var in ("pr", "tasmin", "tasmax"):
        assert (tmp_path / f"b_{var}.png").stat().st_size > 5000


@pytest.mark.parametrize("var,stat,geo", [("pr", "mean", False), ("tasmax", "max", True)],
                         ids=["pr", "tasmax_geo"])
def test_plot_seasonal_maps_matches_jax(tmp_path, var, stat, geo):
    import matplotlib.pyplot as plt

    from probunet_tpu.utils.plotting import plot_seasonal_maps as jax_seasonal

    from probunet_tpu_torch.data.eda import ClimexEDA
    from probunet_tpu_torch.utils.plotting import plot_seasonal_maps

    rng = np.random.default_rng(5)
    hr = np.abs(rng.standard_normal((365, 8, 8, 3))).astype(np.float32)
    seasonal = ClimexEDA(hr).seasonal_stats(var)
    coords = {}
    if geo:
        coords = {"lat": np.linspace(44, 46, 8)[:, None] + np.zeros((1, 8)),
                  "lon": np.zeros((8, 1)) + np.linspace(-75, -72, 8)[None, :]}
    _assert_same_figure(plot_seasonal_maps(seasonal, var, stat=stat, **coords),
                        jax_seasonal(seasonal, var, stat=stat, **coords))
    plt.close("all")
    path = tmp_path / "seasonal.png"
    plot_seasonal_maps(seasonal, var, stat=stat, save_path=str(path), **coords)
    assert path.stat().st_size > 5000


# ---------------------------------------------------------------------------
# wandb
# ---------------------------------------------------------------------------

def _fake_wandb(calls):
    mod = types.ModuleType("wandb")
    mod.log = lambda values, step=None: calls.append((dict(values), step))
    return mod


def test_metric_logger_wandb_hook_matches_jax(tmp_path, monkeypatch):
    from probunet_tpu.train.logging import MetricLogger as JaxLogger

    from probunet_tpu_torch.train.logging import MetricLogger

    calls = {"port": [], "jax": []}
    for name, cls in (("port", MetricLogger), ("jax", JaxLogger)):
        monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls[name]))
        log = cls(logdir=str(tmp_path / name), use_wandb=True, stdout=False)
        log.log({"loss": 0.5, "grad_norm": 2.0}, step=3)
        log.log({"val_crps": 0.25}, kind="epoch")
        log.close()
    assert calls["port"] == calls["jax"] == [({"loss": 0.5, "grad_norm": 2.0}, 3),
                                             ({"val_crps": 0.25}, None)]
    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _fake_wandb(calls))
    MetricLogger(use_wandb=True, stdout=False).log({"loss": torch.tensor(1.5)}, step=1)
    MetricLogger(stdout=False).log({"loss": 1.0}, step=2)          # off by default
    assert calls == [({"loss": 1.5}, 1)]
    monkeypatch.setitem(sys.modules, "wandb", None)               # not installed
    log = MetricLogger(use_wandb=True, stdout=False)
    log.log({"loss": 1.0}, step=1)
    assert log.history[-1]["loss"] == 1.0


def test_train_wandb_runs_without_wandb(tmp_path, monkeypatch, capsys, on_cpu):
    monkeypatch.setitem(sys.modules, "wandb", None)
    out, spans = tcli.main(["train", "--preset", PRESET, "--outdir", str(tmp_path), "--wandb"]
                           + TINY + ["train.num_epochs=1", "train.batch_size=64",
                                     "train.ensemble_size=4", "train.eval_ensemble_size=3"])
    assert out["steps"] == 365 // 64 and "fit" in spans
    assert '"final"' in capsys.readouterr().out
