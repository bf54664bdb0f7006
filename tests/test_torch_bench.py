"""The port's benchmark (``probunet_tpu_torch/bench.py``) and its data
(``data/synthetic.py:synthetic_climex_fields_device``) on the CPU.

- The device generator's arithmetic after the draw equals the JAX
  package's ``synthetic_climex_fields_device`` fed the same white fields
  (``jax.random.normal`` patched to hand them out in draw order), within
  rtol 1e-5 of each channel's largest magnitude (FFT rounding, which is
  relative to the field, not to each value: tasmin crosses 0).
- Every mode, and int8 on ``ensemble`` and ``eval``, runs under
  ``PROBUNET_PLATFORM=cpu`` on a tiny model (the flagship preset with
  narrow widths, bs=2) and prints one JSON line with the root script's
  keys, a ``_cpu_smoke`` name, ``"device": {"name": "cpu"}``, a null peak
  memory, a FLOP count and no ``mfu_*`` key; without the variable and
  without a card it raises.
- The FLOP count is linear in the batch, and the forward count equals the
  sum of 2·N·Cout·Hout·Wout·Cin/groups·kh·kw over the convolutions and
  2·batch·M·K·N over the matrix products, their shapes recorded as the
  model calls them, on both of the ELBO's routes (Fcomb width 8: unfused;
  32: kernel A's plain version).
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch import bench
from probunet_tpu_torch import cli as tcli
from probunet_tpu_torch.config import preset
from probunet_tpu_torch.data.climex import compute_stats
from probunet_tpu_torch.data.synthetic import (
    fields_from_white,
    synthetic_climex_fields_device,
    synthetic_white_noise,
)
from probunet_tpu_torch.data.transforms import apply_physical_transform

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TINY_WIDTHS = {"model.num_filters": [8, 16], "model.model_channels": 8,
               "model.channel_mult": [1, 2], "model.num_blocks": 1, "model.latent_dim": 4}
VARS = ("pr", "tasmin", "tasmax")


@pytest.mark.parametrize("variables", [VARS, ("tasmax", "pr")], ids=["all", "two"])
def test_device_fields_match_the_jax_transform(monkeypatch, variables):
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.synthetic import synthetic_climex_fields_device as jax_fields

    t, h, w = 400, 16, 24
    white = np.random.default_rng(0).standard_normal((5, t, h, w)).astype(np.float32)
    draws = iter(white)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(next(draws)))
    want = np.asarray(jax_fields(t, h, w, variables, seed=0))
    assert next(draws, None) is None          # the five draws, all used
    got = fields_from_white(torch.from_numpy(white), variables).numpy()
    assert got.shape == want.shape == (t, h, w, len(variables)) and got.dtype == np.float32
    for c in range(len(variables)):
        scale = np.abs(want[..., c]).max()
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=1e-5, atol=1e-5 * scale)


def test_device_fields_from_a_generator():
    gen = torch.Generator().manual_seed(5)
    white = synthetic_white_noise(30, 8, 8, gen)
    assert white.shape == (5, 30, 8, 8) and white.dtype == torch.float32
    a = synthetic_climex_fields_device(30, 8, 8, VARS, seed=5, device="cpu")
    b = synthetic_climex_fields_device(30, 8, 8, VARS, device="cpu",
                                       generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.equal(a, fields_from_white(white))
    assert a.shape == (30, 8, 8, 3) and bool(torch.isfinite(a).all())
    assert bool((a[..., 0] >= 0).all()) and bool((a[..., 2] > a[..., 1]).all())
    with pytest.raises(RuntimeError, match="cuda"):
        synthetic_climex_fields_device(2, 8, 8, device="cuda")


@pytest.fixture
def tiny_bench(monkeypatch):
    """The benchmark on the CPU with the flagship preset at narrow widths
    and bs=2 (the smoke run's other sizes kept)."""
    monkeypatch.setenv("PROBUNET_PLATFORM", "cpu")
    for var in ("BENCH_QUANT", "BENCH_QUANT_SKIP", "BENCH_REMAT", "BENCH_DROPOUT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(bench, "preset", lambda name: preset(name).override(TINY_WIDTHS))
    real = bench.bench_config

    def small(mode, on_cpu):
        cfg = real(mode, on_cpu)
        cfg.train.batch_size = 2
        return cfg

    monkeypatch.setattr(bench, "bench_config", small)


MODES = [("train", None, "flops_per_step", "samples/s"),
         ("eval", None, "flops_per_batch", "samples/s"),
         ("msssim", None, "flops_per_step", "samples/s"),
         ("ensemble", None, "flops_per_batch", "member-fields/s"),
         ("ensemble", "int8", "flops_per_batch", "member-fields/s"),
         ("eval", "int8", "flops_per_batch", "samples/s")]


@pytest.mark.parametrize("mode,quant,flops_key,unit", MODES,
                         ids=[m + ("_" + q if q else "") for m, q, _, _ in MODES])
def test_bench_mode_prints_one_line(tiny_bench, monkeypatch, capsys, mode, quant,
                                    flops_key, unit):
    monkeypatch.setenv("BENCH_MODE", mode)
    if quant:
        monkeypatch.setenv("BENCH_QUANT", quant)
    out = bench.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "device",
                        "peak_memory_gb", flops_key}
    assert out["metric"].endswith("_cpu_smoke") and out["unit"] == unit
    assert ("_int8" in out["metric"]) == (quant == "int8")
    assert out["device"] == {"name": "cpu"} and out["peak_memory_gb"] is None
    assert out["value"] > 0 and math.isfinite(out["value"])
    assert isinstance(out[flops_key], int) and out[flops_key] > 0
    anchor = {"train": 123.0, "eval": 530.0, "msssim": 192.0, "ensemble": 2450.0}[mode]
    assert abs(out["vs_baseline"] - out["value"] / anchor) < 1e-3


def test_bench_subcommand_and_skip_name(tiny_bench, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_MODE", "ensemble")
    monkeypatch.setenv("BENCH_QUANT", "int8")
    monkeypatch.setenv("BENCH_QUANT_SKIP", "heads")
    out = tcli.main(["bench"])
    assert out["metric"] == "ensemble16_member_fields_per_sec_128x128_int8_skip_heads_cpu_smoke"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("PROBUNET_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main()
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["bench"])


@pytest.mark.parametrize("value,remat,levels", [
    ("0", False, ()), ("1", True, ()), ("0,", False, (0,)), ("0,1", False, (0, 1)),
    ("2", False, (2,)), ("save_convs", "save_convs", ()), ("save_convs_all", "save_convs_all", ())])
def test_bench_remat_knob(value, remat, levels):
    cfg = bench.bench_config("train", False, {"BENCH_REMAT": value})
    assert cfg.train.remat == remat and tuple(cfg.train.remat_levels) == levels


def test_bench_config_knobs():
    cfg = bench.bench_config("msssim", False, {"BENCH_BS": "32", "BENCH_DTYPE": "float32",
                                               "BENCH_DROPOUT": "0"})
    assert (cfg.train.batch_size, cfg.model.compute_dtype, cfg.model.dropout) == \
        (32, "float32", 0.0)
    assert (cfg.loss.loss_type, cfg.loss.lam_w, cfg.train.ensemble_size) == \
        ("mse+ssim", 0.158, 1)
    cpu = bench.bench_config("train", True, {"BENCH_BS": "32"})
    assert (cpu.data.resolution, cpu.data.lowres_scale, cpu.train.batch_size,
            cpu.train.ensemble_size) == ((64, 64), 8, 8, 4)
    assert bench.bench_config("msssim", True, {}).data.resolution == (128, 128)
    dflt = bench.bench_config("train", False, {})
    assert (dflt.train.batch_size, dflt.train.ensemble_size, dflt.model.compute_dtype,
            dflt.model.dropout) == (128, 15, "bfloat16", 0.1)


def _tiny_setup(width: int, batch: int):
    cfg = bench.bench_config("eval", True, {}).override(
        {**TINY_WIDTHS, "model.num_filters": [width, 16]})
    cfg.data.resolution, cfg.data.lowres_scale = (16, 16), 4
    hr = apply_physical_transform(synthetic_climex_fields_device(
        batch + 4, 16, 16, VARS, seed=1, device="cpu"), VARS)
    return cfg, hr[:batch], compute_stats(hr, 4)


@pytest.mark.parametrize("mode", ["train", "eval", "ensemble"])
def test_flop_count_is_linear_in_the_batch(mode):
    cfg, hr, stats = _tiny_setup(32, 3)
    model = bench.make_model(cfg, "cpu")
    one = bench.flops_per_unit(mode, model, cfg, stats, None, hr, 1)
    work = bench.make_work(mode, bench.make_model(cfg, "cpu"), cfg, stats, None)
    three = bench.count_flops(lambda: work(hr, torch.Generator().manual_seed(0)))
    assert one > 0 and three == 3 * one
    assert bench.flops_per_unit(mode, model, cfg, stats, None, hr, 3) == three


def _matmul_flops(a: torch.Tensor, b: torch.Tensor) -> int:
    ash = (1,) + tuple(a.shape) if a.dim() == 1 else tuple(a.shape)
    bsh = tuple(b.shape) + (1,) if b.dim() == 1 else tuple(b.shape)
    batch = torch.broadcast_shapes(ash[:-2], bsh[:-2])
    return 2 * math.prod(batch) * ash[-2] * ash[-1] * bsh[-1]


def _conv_flops(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> int:
    cout, cin_g, kh, kw = w.shape
    return 2 * y.shape[0] * cout * y.shape[2] * y.shape[3] * cin_g * kh * kw


@pytest.mark.parametrize("width", [8, 32], ids=["unfused", "fused"])
def test_forward_flops_equal_the_shape_count(monkeypatch, width):
    """The eval step's count equals the products' and convolutions' FLOPs
    computed from the shapes each call sees."""
    cfg, hr, stats = _tiny_setup(width, 2)
    model = bench.make_model(cfg, "cpu")
    seen = {"conv": 0, "matmul": 0}
    conv2d, matmul = F.conv2d, torch.matmul

    def conv_rec(x, w, *args, **kw):
        y = conv2d(x, w, *args, **kw)
        seen["conv"] += _conv_flops(x, w, y)
        return y

    def matmul_rec(a, b, **kw):
        seen["matmul"] += _matmul_flops(a, b)
        return matmul(a, b, **kw)

    work = bench.make_work("eval", model, cfg, stats, None)
    counted = bench.count_flops(lambda: work(hr, torch.Generator().manual_seed(0)))
    monkeypatch.setattr(F, "conv2d", conv_rec)
    monkeypatch.setattr(torch, "matmul", matmul_rec)
    work(hr, torch.Generator().manual_seed(0))
    assert seen["conv"] > 0 and seen["matmul"] > 0
    assert counted == seen["conv"] + seen["matmul"]
