"""The port's headline benchmark (port of the root ``bench.py``): the
flagship ELBO train step's throughput, or one of the serve paths'. Prints
ONE JSON line and returns it as a dict.

    python -m probunet_tpu_torch bench
    BENCH_MODE=ensemble BENCH_QUANT=int8 python -m probunet_tpu_torch bench

Modes (``BENCH_MODE``), each scored against the reference's anchor on its
CUDA GPU (BASELINE.md "Throughput", bs=32):

  train (default)  ELBO train step, afCRPS M=15, bs=128   ref ~123 samples/s
  eval             no-grad posterior ELBO, M=5            ref ~530 samples/s
  msssim           train step, WMSE + MS-SSIM ELBO, M=1   ref ~192 samples/s
  ensemble         16-member prior ensemble in HR space   ref ~2,450 member-fields/s

Knobs, as the root script reads them: ``BENCH_BS`` (128), ``BENCH_DTYPE``
(``bfloat16``), ``BENCH_DROPOUT``, ``BENCH_REMAT`` (``0`` off, ``1`` every
U-Net block, a comma list of levels such as ``0,`` for level 0 alone,
``save_convs``, ``save_convs_all``), ``BENCH_QUANT=int8`` (``ensemble`` and
``eval``: convolutions served int8 through kernel E after a calibration
over 4 of the 8 batches) and ``BENCH_QUANT_SKIP`` (``ensemble``: regexes of
convolutions kept in float, ``heads`` the latent heads). As in the JAX
package, ``PROBUNET_ACT_COMPRESS=int8`` builds the model with int8 saved
convolution inputs (``ops.act_compress``; the train modes).

Everything lives on the card: 8 batches of synthetic days made there
(``data.synthetic.synthetic_climex_fields_device``), transformed, their
statistics, the model and its optimizer. Each timed window starts after a
warm-up and ends with a host read of a value that depends on the whole
chain of work in it (the last step's gradient norm; the f32 sum of every
output of every eval or ensemble batch), then ``torch.cuda.synchronize()``.

Besides the root script's keys (``metric``, ``value``, ``unit``,
``vs_baseline``) the line carries:

- ``device``: ``{"name", "power_limit_w"}`` (``torch.cuda.get_device_name``
  and ``nvidia-smi``'s ``power.limit``; null where nvidia-smi is missing);
- ``peak_memory_gb``: ``torch.cuda.max_memory_allocated()`` over the run;
- ``flops_per_step`` (train, msssim) or ``flops_per_batch`` (eval,
  ensemble): ``torch.utils.flop_counter.FlopCounterMode`` over one step or
  batch of the plain route on the CPU at batch 1 (an f32 copy of the model
  with the card's weights, the same preset, mode, M, remat and scales),
  times the batch size. It counts convolutions and matrix products, kernel
  E's integer convolutions included, so the count is the algorithm's work
  whichever implementation runs; on the card the hand-written kernels
  launched through ctypes are invisible to the counter. Elementwise work
  (GroupNorm chains, losses, the optimizer) is not counted;
- ``mfu_vs_h100_bf16_dense_peak``: those FLOPs over the measured time over
  989e12 FLOP/s, the H100 SXM's dense bf16 tensor-core peak at its full
  700 W power limit (a card set lower cannot reach it). The port runs the
  Fcomb products in f32 (``ops.precision.matmul_f32``), so the share is an
  upper bound of the tensor cores' use.

The root script's ``hbm_bytes_per_step`` and ``hbm_bw_util_vs_819GBps``
come from XLA's post-fusion cost analysis; PyTorch has no such count, so
the bytes a step moves are not measured here.

There is no silent CPU route: without a card the script raises. Under
``PROBUNET_PLATFORM=cpu`` it runs on the CPU as the root script's smoke
run does (64x64, lowres 8, bs=8, M=4; ``msssim`` keeps 128x128, since
five-level MS-SSIM needs sides above 96), every metric named with a
``_cpu_smoke`` suffix, ``"device": {"name": "cpu"}``, a null
``peak_memory_gb`` and no ``mfu_*`` key.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import time
from typing import Callable

import torch

from probunet_tpu_torch.cli import cli_device, make_model
from probunet_tpu_torch.config import Config, preset
from probunet_tpu_torch.data.climex import (
    compute_stats,
    lrinterp_from_batch,
    preprocess_batch,
    residual_to_hr,
)
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields_device
from probunet_tpu_torch.data.transforms import apply_physical_transform
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.ops import quantize
from probunet_tpu_torch.train.loop import make_eval_step, make_train_step
from probunet_tpu_torch.train.state import create_train_state
from probunet_tpu_torch.utils.profiling import device_sync

# reference anchors (BASELINE.md "Throughput"; all at bs=32 on 1 CUDA GPU)
BASELINE_TRAIN = 123.0      # 3.84 it/s * 32  (afCRPS ELBO, M=15)
BASELINE_EVAL = 530.0       # 16.6 it/s * 32  (no-grad ELBO, M=5)
BASELINE_MSSSIM = 192.0     # 6.0 it/s * 32   (WMSE-MS-SSIM, M=1)
BASELINE_ENSEMBLE = 2450.0  # 3.83 it/s * 32 * 20 member-fields/s

H100_BF16_DENSE_PEAK_FLOPS = 989e12   # H100 SXM, dense bf16, at 700 W
ENSEMBLE_MEMBERS = 16
N_BATCHES = 8        # distinct batches cycled through
CALIB_BATCHES = 4    # of them, the int8 calibration's
BETA_0, BETA_1 = 1.0, 1e-3


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit (W), or ``{"name": "cpu"}``."""
    if dev.type != "cuda":
        return {"name": "cpu"}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
        power = float(line.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        power = None
    return {"name": torch.cuda.get_device_name(dev), "power_limit_w": power}


def bench_config(mode: str, on_cpu: bool, env=os.environ) -> Config:
    """The flagship preset with the mode's settings and the env knobs
    (``BENCH_REMAT``: ``0`` off, ``1`` every block, ``save_convs`` /
    ``save_convs_all`` the policy modes, anything else a comma list of
    resolution levels: ``"0,"`` is level 0 alone, ``"0"`` is off)."""
    cfg = preset("probunet_multivar_128")
    if on_cpu:  # the smoke run's sizes; real numbers come from the card
        if mode != "msssim":
            cfg.data.resolution = (64, 64)
            cfg.data.lowres_scale = 8
        cfg.train.batch_size = 8
        cfg.train.ensemble_size = 4
    cfg.model.compute_dtype = env.get("BENCH_DTYPE", "bfloat16")
    if not on_cpu:
        cfg.train.batch_size = int(env.get("BENCH_BS", "128"))
    if "BENCH_DROPOUT" in env:
        cfg.model.dropout = float(env["BENCH_DROPOUT"])
    remat = env.get("BENCH_REMAT", "0")
    if remat in ("save_convs", "save_convs_all"):
        cfg.train.remat = remat
    elif "," in remat or remat not in ("0", "1"):
        cfg.train.remat_levels = tuple(int(v) for v in remat.split(",") if v.strip())
    else:
        cfg.train.remat = remat == "1"
    if mode == "msssim":  # BASELINE.md row 3: WMSE-MS-SSIM at M=1
        cfg.loss.loss_type = "mse+ssim"
        cfg.loss.lam_w = 0.158
        cfg.train.ensemble_size = 1
    return cfg


def make_work(mode: str, model: ProbabilisticUNet, cfg: Config, stats,
              quant: dict | None) -> Callable:
    """``work(hr_batch, generator) -> tensor``: one unit of the mode's
    timed work on ``model``'s device (a train step, returning its gradient
    norm; an eval step, returning its loss; a prior ensemble in HR space)."""
    d = cfg.data
    if mode in ("train", "msssim"):
        state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                                   device=next(model.parameters()).device)
        step = make_train_step(model, cfg)

        def work(hr, gen):
            return step(state, hr, stats, BETA_0, BETA_1)[1]["grad_norm"]
    elif mode == "eval":
        step = make_eval_step(model, cfg, quant=quant)

        def work(hr, gen):
            return step(hr, stats, gen)["loss"]
    elif mode == "ensemble":
        @torch.no_grad()
        def work(hr, gen):
            batch = preprocess_batch(hr, stats, d.pipeline, d.lowres_scale, d.interp_mode,
                                     d.epsilon, d.standardization)
            with quantize.attached(model, quant):
                out = model.sample(batch["inputs"], ENSEMBLE_MEMBERS, generator=gen)
            lrinterp = lrinterp_from_batch(batch, d.lowres_scale, d.interp_mode)
            return residual_to_hr(out, lrinterp[:, None], stats, d.pipeline, d.epsilon,
                                  d.standardization)
    else:
        raise ValueError(f"BENCH_MODE={mode!r}: one of train, eval, msssim, ensemble")
    return work


def count_flops(run: Callable[[], object]) -> int:
    """FLOPs of ``run()`` as ``FlopCounterMode`` counts them (convolutions
    and matrix products, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    return int(counter.get_total_flops())


def flops_per_unit(mode: str, model: ProbabilisticUNet, cfg: Config, stats, quant,
                   hr: torch.Tensor, batch_size: int) -> int:
    """The FLOPs of one ``make_work`` unit at ``batch_size``: counted on an
    f32 copy of ``model`` on the CPU (the card's weights; the kernels' plain
    versions run there) over the first item of ``hr``, times
    ``batch_size``. The count does not depend on the element type."""
    cfg32 = copy.deepcopy(cfg)
    cfg32.model.compute_dtype = "float32"
    cpu = make_model(cfg32, "cpu")
    cpu.load_state_dict(model.state_dict())
    stats_cpu = type(stats)(*[None if t is None else t.cpu() for t in stats])
    work = make_work(mode, cpu, cfg32, stats_cpu, quant)
    return batch_size * count_flops(lambda: work(hr[:1].cpu(), torch.Generator().manual_seed(0)))


def _metric(mode: str, b: int, quant: dict | None, on_cpu: bool) -> tuple[str, str, float]:
    """(metric name, unit, anchor) of the root script's line."""
    if mode == "ensemble":
        suffix = ""
        if quant is not None:
            suffix = "_int8"
            if os.environ.get("BENCH_QUANT_SKIP"):
                suffix += "_skip_" + os.environ["BENCH_QUANT_SKIP"].replace(",", "_")
        name = f"ensemble{ENSEMBLE_MEMBERS}_member_fields_per_sec_128x128{suffix}"
        unit, anchor = "member-fields/s", BASELINE_ENSEMBLE
    elif mode == "eval":
        name = f"eval_samples_per_sec_128x128_elbo_M5_bs{b}" + ("_int8" if quant else "")
        unit, anchor = "samples/s", BASELINE_EVAL
    elif mode == "msssim":
        name, unit, anchor = f"train_samples_per_sec_128x128_msssim_M1_bs{b}", "samples/s", \
            BASELINE_MSSSIM
    else:
        name = "train_samples_per_sec" if on_cpu else \
            f"train_samples_per_sec_128x128_afcrps_M15_bs{b}"
        unit, anchor = "samples/s", BASELINE_TRAIN
    return name + ("_cpu_smoke" if on_cpu else ""), unit, anchor


def _calibrate(mode: str, model, cfg: Config, stats, batches) -> dict | None:
    """``BENCH_QUANT=int8``: the scales tree of the mode's serve path over
    the first ``CALIB_BATCHES`` batches; None otherwise."""
    if os.environ.get("BENCH_QUANT") != "int8" or mode not in ("ensemble", "eval"):
        return None
    cal = batches[:CALIB_BATCHES]
    if mode == "eval":
        return quantize.calibrate_elbo(model, cal, cfg, stats)
    d = cfg.data
    inputs = [preprocess_batch(h, stats, d.pipeline, d.lowres_scale, d.interp_mode,
                               d.epsilon, d.standardization)["inputs"] for h in cal]
    scales = quantize.calibrate_sample(model, inputs, ENSEMBLE_MEMBERS)
    if os.environ.get("BENCH_QUANT_SKIP"):
        scales = quantize.quant_skip(scales, os.environ["BENCH_QUANT_SKIP"].split(","))
    return scales


def main() -> dict:
    """Run the mode ``BENCH_MODE`` names, print its JSON line, return it."""
    dev = cli_device()
    on_cpu = dev.type == "cpu"
    mode = os.environ.get("BENCH_MODE", "train")
    cfg = bench_config(mode, on_cpu)
    b, res = cfg.train.batch_size, cfg.data.resolution
    if not on_cpu:
        torch.cuda.reset_peak_memory_stats(dev)

    # synthetic ClimEx-like data, made and kept on the device
    hr = synthetic_climex_fields_device(N_BATCHES * b, res[0], res[1], cfg.data.variables,
                                        seed=0, device=dev)
    hr = apply_physical_transform(hr, cfg.data.variables)
    stats = compute_stats(hr, cfg.data.lowres_scale)
    batches = list(hr.split(b))
    # the root script's model (its bench.py:166-181): the config's widths,
    # dtype and remat, initialized from a generator seeded train.seed
    model = make_model(cfg, dev)
    quant = _calibrate(mode, model, cfg, stats, batches)
    work = make_work(mode, model, cfg, stats, quant)
    gen = torch.Generator(device=dev).manual_seed(0)

    if mode in ("train", "msssim"):
        for i in range(2):  # warm-up
            out = work(batches[i % N_BATCHES], gen)
        device_sync(out)
        units = 10 if on_cpu else 30
        t0 = time.perf_counter()
        for i in range(units):
            out = work(batches[i % N_BATCHES], gen)
        device_sync(out)   # the last step's grad norm depends on every step
    else:
        n_reps = {"eval": 2, "ensemble": 1}[mode] if on_cpu else 8

        def epoch(acc):
            for hr_b in batches:  # every output stays a live dependency of the sum
                acc = acc + work(hr_b, gen).float().sum()
            return acc

        device_sync(epoch(torch.zeros((), device=dev)))   # warm-up
        t0 = time.perf_counter()
        acc = torch.zeros((), device=dev)
        for _ in range(n_reps):
            acc = epoch(acc)
        device_sync(acc)
        units = n_reps * N_BATCHES
    dt = time.perf_counter() - t0
    peak_gb = None if on_cpu else torch.cuda.max_memory_allocated(dev) / 1e9

    per_unit = b * (ENSEMBLE_MEMBERS if mode == "ensemble" else 1)
    rate = units * per_unit / dt
    name, unit, anchor = _metric(mode, b, quant, on_cpu)
    result = {"metric": name, "value": round(rate, 2), "unit": unit,
              "vs_baseline": round(rate / anchor, 3), "device": device_info(dev),
              "peak_memory_gb": peak_gb}
    flops = flops_per_unit(mode, model, cfg, stats, quant, batches[0], b)
    result["flops_per_step" if mode in ("train", "msssim") else "flops_per_batch"] = flops
    if not on_cpu:
        result["mfu_vs_h100_bf16_dense_peak"] = round(
            flops * units / dt / H100_BF16_DENSE_PEAK_FLOPS, 4)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
