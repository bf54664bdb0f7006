#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``probunet_tpu_torch/csrc`` with
nvcc (sm_90a), holds each kernel against its plain PyTorch version at the
serve shapes, checks the whole f32 path on the card against the CPU path on
a small input, then drives the serve path at the full width of the
flagship preset (``probunet_multivar_128``, bf16, randomly initialized
weights): the no-grad eval ELBO (bs=128, M=5), once fused (fcomb-CRPS
kernel) and once unfused (afCRPS-terms kernel), and the prior-ensemble
evaluation (M=16) through ``EvalAccumulator``. Launch counters show that
the main path went through both kernels.

Needs a CUDA device and nvcc; there is no CPU route. Any failed check
raises, so the exit code is 0 only when every phase passed. The line
before the last is a JSON object with each kernel's launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from probunet_tpu.config import preset
from probunet_tpu_torch.data.climex import (
    compute_stats,
    lrinterp_from_batch,
    preprocess_batch,
    residual_to_hr,
)
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.data.transforms import apply_physical_transform, invert_physical_transform
from probunet_tpu_torch.evals.streaming import EvalAccumulator
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.ops.kernels import _build, afcrps, fcomb_crps
from probunet_tpu_torch.train.loop import eval_model, make_eval_step

BATCH = 128          # bench.py's serve batch
N_BATCHES = 3
ENSEMBLE_M = 16      # bench.py's prior-ensemble size
# kernel vs plain version on the card, f32 and bf16: the same rounding
# points, sums in another order (per-thread then fixed-order block sums vs
# ATen's reductions); 2.3e-7 reached on an H100
KERNEL_RTOL = 1e-5
# fused (kernel A) vs unfused (Fcomb.ensemble + kernel B) bf16 eval ELBO:
# the same bf16 operand rounding, but a hidden value whose f32 sum differs
# in its last bit can round to the other bf16 neighbour
FUSED_RTOL = 1e-4
# f32 serve path on the card (kernels, TF32 off) vs on the CPU (plain
# versions): convolution and reduction orders differ through ~50 layers.
# The ELBO's scalars average that away (5.9e-7 reached); single ensemble
# values keep it (4.5e-5 of the largest value reached)
DEVICE_RTOL = 1e-4
ENSEMBLE_RTOL = 2e-4


def _sync_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(got, want) -> tuple[float, float]:
    """(max abs error, max relative error) over tuples of tensors."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for g, w in zip(got, want))
    return abs_err, rel_err


def kernels_vs_plain(dev: torch.device) -> dict[str, dict]:
    """Each kernel against its plain version at the serve shapes."""
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    report = {}
    b, c, p, k = BATCH, 32, 128 * 128, 3
    rows = []
    for m in (5, 16):
        for dtype in ("bfloat16", "float32"):
            args = (randn(b, c, p), randn(b, c, m), randn(c, c, scale=c ** -0.5),
                    randn(c, scale=0.1), randn(c, k, scale=c ** -0.5), randn(k, scale=0.1),
                    randn(b, k, p))
            got = fcomb_crps.fcomb_crps_terms(*args, compute_dtype=dtype)
            want = fcomb_crps.fcomb_crps_terms_plain(*args, compute_dtype=dtype)
            abs_err, rel_err = _errors(got, want)
            ms = _sync_ms(lambda: fcomb_crps.fcomb_crps_terms(*args, compute_dtype=dtype), 20)
            plain_ms = _sync_ms(
                lambda: fcomb_crps.fcomb_crps_terms_plain(*args, compute_dtype=dtype), 3, 1)
            print(f"kernel fcomb_crps  B={b} C={c} P={p} K={k} M={m:2d} {dtype:8s} "
                  f"max_rel_err={rel_err:.3e} max_abs_err={abs_err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not rel_err <= KERNEL_RTOL:
                raise AssertionError(f"fcomb_crps kernel disagrees with its plain version: "
                                     f"rel err {rel_err} > {KERNEL_RTOL}")
            rows.append((m, dtype, abs_err, ms, plain_ms))
            del args, got, want
    # the eval ELBO's shape: M = 5, bf16 compute
    main = next(r for r in rows if r[:2] == (5, "bfloat16"))
    report["fcomb_crps"] = {"max_abs_err": max(r[2] for r in rows),
                            "ms": main[3], "plain_ms": main[4]}

    p = 128 * 128 * 3
    rows = []
    for m in (5, 16):
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            ens, tgt = randn(b, m, p).to(tdt), randn(b, p).to(tdt)
            got = afcrps.ensemble_crps_terms(ens, tgt)
            want = afcrps.ensemble_crps_terms_plain(ens, tgt)
            abs_err, rel_err = _errors(got, want)
            ms = _sync_ms(lambda: afcrps.ensemble_crps_terms(ens, tgt), 20)
            plain_ms = _sync_ms(lambda: afcrps.ensemble_crps_terms_plain(ens, tgt), 5, 1)
            print(f"kernel afcrps      B={b} P={p} M={m:2d} {dtype:8s} "
                  f"max_rel_err={rel_err:.3e} max_abs_err={abs_err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not rel_err <= KERNEL_RTOL:
                raise AssertionError(f"afcrps kernel disagrees with its plain version: "
                                     f"rel err {rel_err} > {KERNEL_RTOL}")
            rows.append((m, dtype, abs_err, ms, plain_ms))
            del ens, tgt, got, want
    # the unfused bf16 eval ELBO feeds the kernel an f32 ensemble (Fcomb
    # casts its output to the f32 feature dtype) at M = 5
    main = next(r for r in rows if r[:2] == (5, "float32"))
    report["afcrps"] = {"max_abs_err": max(r[2] for r in rows),
                        "ms": main[3], "plain_ms": main[4]}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def _fill_zero_params(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Give the zero-initialized parameters (each block's conv1, the U-Net's
    out_conv, GN shifts) random values: at a fresh init the U-Net's
    features are exactly 0 and the kernels' feature input would be
    constant."""
    with torch.no_grad():
        for prm in model.parameters():
            if not bool(prm.any()):
                std = prm[0].numel() ** -0.5 if prm.dim() > 1 else 0.02
                prm.copy_(std * torch.randn(prm.shape, generator=gen))


def device_vs_cpu(model32: ProbabilisticUNet, hr: torch.Tensor, stats, cfg,
                  dev: torch.device) -> None:
    """The f32 serve path on the card (kernels) against the same path on the
    CPU (plain versions), on two items with shared numpy noise."""
    eps = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (cfg.train.eval_ensemble_size, 2, cfg.model.latent_dim)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        model32.to(where)
        st = type(stats)(*[s.to(where) for s in stats])
        batch = preprocess_batch(hr[:2].to(where), st, cfg.data.pipeline,
                                 cfg.data.lowres_scale, cfg.data.interp_mode,
                                 cfg.data.epsilon, cfg.data.standardization)
        with torch.no_grad():
            for fused in (True, False):
                _, met = model32.elbo(batch["inputs"], batch["targets"],
                                      M=cfg.train.eval_ensemble_size, eps=eps.to(where),
                                      fused=fused)
                out[(str(where), fused)] = (float(met["recon"]), float(met["kl_mean"]))
            ens = model32.sample(batch["inputs"], 3, eps=eps[:3].to(where))
            out[(str(where), "sample")] = ens.cpu()
    for fused in (True, False):
        for i, name in enumerate(("recon", "kl_mean")):
            c, g = out[("cpu", fused)][i], out[(str(dev), fused)][i]
            rel = abs(g - c) / abs(c)
            print(f"device vs cpu f32 elbo fused={fused} {name}: cuda={g:.7g} cpu={c:.7g} "
                  f"rel_err={rel:.3e}")
            if not rel <= DEVICE_RTOL:
                raise AssertionError(f"{name} on the card differs from the CPU path: {rel}")
    ec, eg = out[("cpu", "sample")], out[(str(dev), "sample")]
    rel = float((eg - ec).abs().max() / ec.abs().max())
    print(f"device vs cpu f32 prior ensemble: max_err/max_abs={rel:.3e}")
    if not rel <= ENSEMBLE_RTOL:
        raise AssertionError(f"the prior ensemble on the card differs from the CPU path: {rel}")
    model32.to("cpu")


def serve(model: ProbabilisticUNet, batches: list[torch.Tensor], stats, cfg,
          dev: torch.device) -> dict:
    """The serve path: eval ELBO fused and unfused, then the prior ensemble."""
    res = {}
    steps = {fused: make_eval_step(model, cfg, fused=fused) for fused in (True, False)}
    for i, hr in enumerate(batches):  # fused vs unfused on the same posterior noise
        m = {}
        for fused, step in steps.items():
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            m[fused] = {k: float(v) for k, v in step(hr, stats, gen).items()}
        rel = abs(m[True]["recon"] - m[False]["recon"]) / abs(m[False]["recon"])
        print(f"eval batch {i}: fused recon={m[True]['recon']:.7g} "
              f"unfused recon={m[False]['recon']:.7g} rel_diff={rel:.3e} "
              f"kl_mean={m[True]['kl_mean']:.7g}")
        if not all(math.isfinite(v) for mm in m.values() for v in mm.values()):
            raise AssertionError(f"non-finite eval metrics: {m}")
        if not rel <= FUSED_RTOL:
            raise AssertionError(f"fused and unfused recon differ by {rel} > {FUSED_RTOL}")
        if m[True]["kl_mean"] != m[False]["kl_mean"]:
            raise AssertionError("the two routes encoded the batch differently")
    for fused, step in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_model(step, batches, stats, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rate = len(batches) * BATCH / dt
        name = "fused" if fused else "unfused"
        res[f"eval_{name}_samples_per_s"] = rate
        print(f"eval_model {name}: recon={out['recon']:.7g} kl={out['kl']:.7g} "
              f"samples/s={rate:.2f}")

    gen = torch.Generator(device=dev).manual_seed(2024)
    acc = EvalAccumulator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hr in batches:
        batch = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                                 cfg.data.interp_mode, cfg.data.epsilon,
                                 cfg.data.standardization)
        with torch.no_grad():
            ens = model.sample(batch["inputs"], ENSEMBLE_M, generator=gen)
        lrinterp = lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)
        hr_pred = residual_to_hr(ens, lrinterp[:, None], stats, cfg.data.pipeline,
                                 cfg.data.epsilon, cfg.data.standardization)
        pred = invert_physical_transform(hr_pred, cfg.data.variables)
        gt = invert_physical_transform(batch["hr"], cfg.data.variables)
        if tuple(pred.shape) != (BATCH, ENSEMBLE_M, *cfg.data.resolution,
                                 len(cfg.data.variables)):
            raise AssertionError(f"ensemble shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            raise AssertionError("non-finite ensemble members")
        acc.update(pred, gt)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = acc.result()
    res["ensemble_member_fields_per_s"] = len(batches) * BATCH * ENSEMBLE_M / dt
    for key in ("crps", "mae"):
        if not np.isfinite(out[key]["mean"]).all():
            raise AssertionError(f"non-finite {key}")
    for i, v in enumerate(cfg.data.variables):
        print(f"ensemble M={ENSEMBLE_M} {v}: crps={out['crps']['mean'][i]:.5g} "
              f"mae={out['mae']['mean'][i]:.5g} spread={out['spread'][i]:.5g}")
    print(f"ensemble items={out['items']} "
          f"member-fields/s={res['ensemble_member_fields_per_s']:.2f}")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run "
                         "needs a CUDA device and has no CPU route")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    info = _build.build()
    _build.library()
    print(f"kernel build: {info['path']} built={info['built']} "
          f"seconds={info['seconds']:.2f}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    report = kernels_vs_plain(dev)

    cfg = preset("probunet_multivar_128")
    cfg.model.compute_dtype = "bfloat16"     # as bench.py serves it
    days = N_BATCHES * BATCH
    t0 = time.perf_counter()
    hr_phys = torch.from_numpy(synthetic_climex_fields(
        days, *cfg.data.resolution, cfg.data.variables, seed=0)).to(dev)
    hr = apply_physical_transform(hr_phys, cfg.data.variables)
    stats = compute_stats(hr, cfg.data.lowres_scale)
    batches = list(hr.split(BATCH))
    print(f"data: {days} synthetic days {tuple(hr.shape)} in "
          f"{time.perf_counter() - t0:.2f} s")

    gen = torch.Generator().manual_seed(0)
    model = ProbabilisticUNet.from_config(cfg, gen)
    _fill_zero_params(model, gen)
    cfg32 = preset("probunet_multivar_128")
    model32 = ProbabilisticUNet.from_config(cfg32, torch.Generator().manual_seed(0))
    model32.load_state_dict(model.state_dict())
    device_vs_cpu(model32.eval(), hr.cpu(), type(stats)(*[s.cpu() for s in stats]),
                  cfg32, dev)
    del model32
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: probunet_multivar_128 bf16, {n_params} parameters")

    counters = {"fcomb_crps": fcomb_crps.fcomb_crps_terms, "afcrps": afcrps.ensemble_crps_terms}
    for fn in counters.values():
        fn.launches = 0
    rates = serve(model, batches, stats, cfg, dev)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"launches on the serve path: {launches}; rates: {json.dumps(rates)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serve path")

    modules = {"fcomb_crps": fcomb_crps, "afcrps": afcrps}
    kernels = [{"name": name, "route": "cuda", "source": modules[name].SOURCE,
                "replaces": modules[name].REPLACES, "launches": launches[name],
                **report[name]} for name in ("fcomb_crps", "afcrps")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
