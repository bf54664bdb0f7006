#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``probunet_tpu_torch/csrc`` with
nvcc (sm_90a) and holds each against its plain PyTorch version on the card,
at the shapes of the serve and training paths: the fcomb-CRPS forward (A)
and backward (A′), the afCRPS-terms forward (B) and backward (B′), the
GroupNorm chain's forward (C) and backward (C′), and the hash dropout (D),
with each kernel's time beside its plain version's and its bound; A and
A′ on both of their kernels (bf16 operands on the tensor cores, f32 on
the FP32 pipes), C and C′ on their per-shape plans and on the other
route (a cluster per slab, or three passes for C and two for C′) with
both times, C at every flagship chain shape on every cluster layout, and
the registers and spills nvcc reports for them. Then it
checks the f32 serve path and the f32 training step (gradients and one
AdamW update) on the card against the CPU, both on the GroupNorm kernel
route, and drives both paths at the full width of the flagship preset
(``probunet_multivar_128``, bf16, randomly initialized weights):

- serve: the no-grad eval ELBO (bs=128, M=5), fused (A) and unfused (B),
  and the prior-ensemble evaluation (M=16) through ``EvalAccumulator``,
  every U-Net GroupNorm chain through C (57 launches per U-Net forward),
  with a breakdown of the eval step's device time on the kernel route and
  on the composed route (torch GroupNorm composition);
- train: the ELBO training step (bs=128, M=15, dropout 0.1, beta_1 = 1,
  AdamW lr 1e-4 wd 0.01) on six routes: fused (A, A′, C, C′) and unfused
  (B, B′, C, C′) on the kernel route; fused on the composed route (A, A′,
  D); fused on the kernel route under ``remat="save_convs"``, ``True`` and
  the level tuple ``(0,)``, whose first loss must equal the no-remat
  route's and whose gradients of one step must agree with it (a wrong
  dropout mask in one block's recompute is shown to exceed that limit).
  Train samples/s, peak memory and a breakdown of the step's device time;
  how many GroupNorm chains get an input or gradient that is not
  channels_last.

Each path's launch counters are set to 0 just before it and read just
after: every kernel of the path must have launched. Needs a CUDA device and
nvcc; there is no CPU route. Any failed check raises, so the exit code is
0 only when every phase passed. The line before the last is a JSON object
with each kernel's launches on the training path, error, times and bound;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import ctypes
import json
import math
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from probunet_tpu_torch.config import preset
from probunet_tpu_torch.data.climex import (
    compute_stats,
    lrinterp_from_batch,
    preprocess_batch,
    residual_to_hr,
)
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.data.transforms import apply_physical_transform, invert_physical_transform
from probunet_tpu_torch.evals.streaming import EvalAccumulator
from probunet_tpu_torch.models.layers import EDMGroupNorm
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.models.unet import dropout_seeds
from probunet_tpu_torch.ops.kernels import _build, afcrps, dropout, fcomb_crps, fused_gn
from probunet_tpu_torch.train.loop import eval_model, make_eval_step, make_train_step
from probunet_tpu_torch.train.state import create_train_state, global_norm

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
# kernel A′ vs its plain version. Sums (dz over 16384 pixels; dW1, db1,
# dW2, db2 over 2.1e6 (batch, pixel) pairs, of 15 members each) are taken
# in another order: max error over max value 1e-4 in f32; in bf16 a hidden
# value whose f32 sum differs in its last bit can round to the other bf16
# neighbour, so 1e-3. The per-pixel outputs (dfeat, dy) are exact up to
# sign ties: the kernel's and the plain decode differ in the last bits of x,
# so where x_j - y or x_j - x_k is within ~1e-7 of 0 a sign can flip and
# that pixel's value moves by 2 g. At most 1e-5 of their elements may
# differ by more than 1e-4 of the largest value.
BWD_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
TIE_FRACTION = 1e-5
# f32 training step on the card vs the CPU, per parameter: ||g_cuda -
# g_cpu|| / ||g_cpu||. The CRPS gradient is a sum of signs of x_j - y and
# x_j - x_k: the f32 forwards of the two devices differ by up to ~4.5e-5
# of the largest ensemble value (the prior-ensemble check), so member
# pairs closer than that flip sign and move their pixel's gradient by 2 g.
# The phase prints the CPU gradients' own change under a 1e-6 relative
# move of the inputs beside the card-vs-CPU error. Reached on an H100:
# median 3.6e-4, max 1.5e-3 (two items, M=15)
GRAD_RTOL = 1e-2
# the first AdamW step moves each weight by ~lr * sign(g) plus the same
# decay on both devices, so steps agree to far under lr or, where a
# gradient's sign lies inside the two devices' f32 noise, differ by ~2 lr.
# The share of weights that stepped the other way: 1.5e-4 reached on an
# H100 on either route. A wrong gradient flips about half of its
# parameter's weights; the per-parameter check is GRAD_RTOL's
FLIP_SHARE = 2e-3
# the remat modes the training path runs (each one route)
REMAT_MODES = ("save_convs", True, (0,))
# remat vs no remat, one training step's gradients on the same batch, noise
# and seed words, max over parameters of ||g - g_plain|| / ||g_plain||: the
# forward is the same launches on the same inputs, so the backward may
# differ only by the card's run-to-run noise (cuDNN's weight-gradient sums
# need not be bit-identical). Reached on an H100: 0.0 for the no-remat
# route against itself and for every remat mode (bit-identical), 0.68 with
# one block's dropout seed words changed (a recompute with a wrong mask)
REMAT_GRAD_RTOL = 1e-3
TRAIN_BATCH, TRAIN_M = 128, 15   # bench.py's training step
TRAIN_WARMUP, TRAIN_STEPS = 2, 4
# kernels C and C′ vs their plain versions. y and dx: in bf16 one bf16
# step at the largest value (2^-7 of it): the statistics are f32 sums in
# another order, so an output near a rounding boundary can round to the
# other neighbour; in f32 1e-5 of the largest value. mean, rstd and the
# parameter gradients, f32 sums over up to B*H*W = 2.1e6 elements in
# another order: 1e-4 of the largest value. Dropout masks: equal.
GN_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
GN_SUM_TOL = 1e-4
# (B, H, W, C), dtype, FiLM, p_drop (SiLU on, as in every U-Net chain): the
# dominant norm1 (the JSON row), the largest slab (norm0 of
# dec_128x128_block0, after the skip concat), the widest level, one f32
GN_CASES = (((128, 128, 128, 32), "bfloat16", True, 0.1),
            ((128, 128, 128, 96), "bfloat16", False, 0.0),
            ((128, 16, 16, 512), "bfloat16", True, 0.1),
            ((128, 64, 64, 64), "float32", True, 0.1))
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; FP32 CUDA core


def _sync_ms(fn, iters: int, warmup: int = 2, spin: bool = True) -> float:
    """Mean milliseconds per call by CUDA events, after warm-up. With
    ``spin`` the device first spins for ~50 ms, so the host enqueues the
    timed calls while it waits and a kernel shorter than its launch's host
    overhead is timed on the device, not on the host. Steps are timed
    without it: their time includes the device's waits for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(100_000_000)  # cycles, ~50 ms at ~2 GHz
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


def _bound(n_bytes: float, n_ops: float, dtype: str) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for the type, whichever is larger."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return ({"bound_ms": t_bytes, "bound_by": "bytes"} if t_bytes >= t_ops
            else {"bound_ms": t_ops, "bound_by": "operations"})


def _max_err_ratio(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# the kernels whose registers and spills the run prints (A's and A′'s two
# kernels each, C's and C′'s two routes each)
PTXAS_KERNELS = ("fcomb_crps_fwd_mma_kernel", "fcomb_crps_tile_kernel",
                 "fcomb_crps_bwd_mma_kernel", "fcomb_crps_bwd_tile_kernel",
                 "gn_fwd_cluster_kernel", "gn_fwd_stats_kernel", "gn_fwd_apply_kernel",
                 "gn_bwd_cluster_kernel", "gn_bwd_reduce_kernel", "gn_bwd_dx_kernel")


def _ptxas_report(log: str, names) -> dict:
    """Registers and spill bytes of each compiled entry whose name holds one
    of ``names``, from nvcc's ``-Xptxas -v`` log (empty when the library was
    not built in this run)."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            entry = next((f"{n} {mangled}" for n in names if n in mangled), None)
        elif entry and "spill stores" in line:
            words = line.split()
            out.setdefault(entry, {})["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[entry]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif entry and "Used" in line and "registers" in line:
            words = line.split()
            out.setdefault(entry, {})["registers"] = int(words[words.index("registers,") - 1]
                                                         if "registers," in words
                                                         else words[words.index("registers") - 1])
            entry = None
    return out


def kernels_vs_plain(dev: torch.device) -> dict[str, dict]:
    """Each kernel against its plain version at the serve and training
    shapes. The JSON row of a kernel carries its training-path shape: M=15
    bf16 for A and A′, M=15 f32 for B and B′ (the unfused route scores
    Fcomb's f32 output), the (128, 128, 128, 32) bf16 activation for D."""
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    report = {}
    b, c, p, k = BATCH, 32, 128 * 128, 3
    for m in (TRAIN_M, 5):
        for dtype in ("bfloat16", "float32"):
            args = (randn(b, c, p), randn(b, c, m), randn(c, c, scale=c ** -0.5),
                    randn(c, scale=0.1), randn(c, k, scale=c ** -0.5), randn(k, scale=0.1),
                    randn(b, k, p))
            g1, g2 = randn(b, scale=1e-3), randn(b, scale=1e-3)
            # forward (A), twice for bit-reproducibility
            got = fcomb_crps.fcomb_crps_terms_fwd(*args, compute_dtype=dtype)
            again = fcomb_crps.fcomb_crps_terms_fwd(*args, compute_dtype=dtype)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError("fcomb_crps forward is not bit-reproducible")
            want = fcomb_crps.fcomb_crps_terms_plain(*args, compute_dtype=dtype)
            abs_err, rel_err = _errors(got, want)
            ms = _sync_ms(lambda: fcomb_crps.fcomb_crps_terms_fwd(*args, compute_dtype=dtype), 10)
            plain_ms = _sync_ms(
                lambda: fcomb_crps.fcomb_crps_terms_plain(*args, compute_dtype=dtype), 2, 1)
            print(f"kernel fcomb_crps      B={b} C={c} P={p} K={k} M={m:2d} {dtype:8s} "
                  f"kernel={fcomb_crps.FWD_KERNELS[dtype]} bit_reproducible=True "
                  f"max_rel_err={rel_err:.3e} max_abs_err={abs_err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not rel_err <= KERNEL_RTOL:
                raise AssertionError(f"fcomb_crps kernel disagrees with its plain version: "
                                     f"rel err {rel_err} > {KERNEL_RTOL}")
            ops = 2.0 * b * p * m * (c * c + c * k)
            if (m, dtype) == (TRAIN_M, "bfloat16"):
                report["fcomb_crps"] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                                        **_bound(4.0 * b * p * (c + k), ops, dtype),
                                        "library_ms": None}
            # backward (A′): all seven outputs, twice for bit-reproducibility
            got = fcomb_crps.fcomb_crps_terms_bwd(*args, g1, g2, dtype)
            again = fcomb_crps.fcomb_crps_terms_bwd(*args, g1, g2, dtype)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError("fcomb_crps backward is not bit-reproducible")
            want = fcomb_crps.fcomb_crps_terms_bwd_plain(*args, g1, g2, dtype)
            names = ("dfeat", "dz", "dW1", "db1", "dW2", "db2", "dy")
            errs = {n: _max_err_ratio(x, y) for n, x, y in zip(names, got, want)}
            ties = {n: float(((x - y).abs() > 1e-4 * y.abs().max()).float().mean())
                    for n, x, y in zip(names, got, want) if n in ("dfeat", "dy")}
            abs_err = max(float((x - y).abs().max()) for x, y in zip(got, want))
            ms = _sync_ms(lambda: fcomb_crps.fcomb_crps_terms_bwd(*args, g1, g2, dtype), 3, 1)
            plain_ms = _sync_ms(
                lambda: fcomb_crps.fcomb_crps_terms_bwd_plain(*args, g1, g2, dtype), 1, 1)
            print(f"kernel fcomb_crps_bwd  B={b} C={c} P={p} K={k} M={m:2d} {dtype:8s} "
                  f"bit_reproducible=True max_err/max={json.dumps(errs)} "
                  f"tie_fraction={json.dumps(ties)} max_abs_err={abs_err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            bad = {n: e for n, e in errs.items()
                   if n not in ("dfeat", "dy") and not e <= BWD_RTOL[dtype]}
            bad.update({n: f for n, f in ties.items() if not f <= TIE_FRACTION})
            if bad:
                raise AssertionError(f"fcomb_crps backward disagrees with its plain version: "
                                     f"{bad}")
            if (m, dtype) == (TRAIN_M, "bfloat16"):
                # the algorithm's products: decode (C^2 + CK), dh1, dW2 (CK
                # each), dh0, dW1 (C^2 each); read feat, y; write dfeat, dy
                ops = 2.0 * b * p * m * (3 * c * c + 3 * c * k)
                report["fcomb_crps_bwd"] = {"max_abs_err": abs_err, "ms": ms,
                                            "plain_ms": plain_ms,
                                            **_bound(8.0 * b * p * (c + k), ops, dtype),
                                            "library_ms": None}
            del args, got, again, want
    torch.cuda.empty_cache()

    p = 128 * 128 * 3
    for m in (TRAIN_M, 5):
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            ens, tgt = randn(b, m, p).to(tdt), randn(b, p).to(tdt)
            ens[:, 1, :64] = ens[:, 0, :64]  # ties: sign 0
            g1, g2 = randn(b, scale=1e-3), randn(b, scale=1e-3)
            got = afcrps.ensemble_crps_terms_fwd(ens, tgt)
            want = afcrps.ensemble_crps_terms_plain(ens, tgt)
            abs_err, rel_err = _errors(got, want)
            ms = _sync_ms(lambda: afcrps.ensemble_crps_terms_fwd(ens, tgt), 20)
            plain_ms = _sync_ms(lambda: afcrps.ensemble_crps_terms_plain(ens, tgt), 3, 1)
            print(f"kernel afcrps          B={b} P={p} M={m:2d} {dtype:8s} "
                  f"max_rel_err={rel_err:.3e} max_abs_err={abs_err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not rel_err <= KERNEL_RTOL:
                raise AssertionError(f"afcrps kernel disagrees with its plain version: "
                                     f"rel err {rel_err} > {KERNEL_RTOL}")
            size = ens.element_size()
            pair_ops = 3.0 * b * p * (m + m * (m - 1) / 2)  # sub, abs, add per term
            if (m, dtype) == (TRAIN_M, "float32"):
                report["afcrps"] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                                    **_bound(size * b * p * (m + 1), pair_ops, "float32"),
                                    "library_ms": None}
            got = afcrps.ensemble_crps_terms_bwd(ens, tgt, g1, g2)
            want = afcrps.ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2)
            exact = all(torch.equal(x, y) for x, y in zip(got, want))
            abs_err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
            ms = _sync_ms(lambda: afcrps.ensemble_crps_terms_bwd(ens, tgt, g1, g2), 20)
            plain_ms = _sync_ms(lambda: afcrps.ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2),
                                3, 1)
            print(f"kernel afcrps_bwd      B={b} P={p} M={m:2d} {dtype:8s} exact={exact} "
                  f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            # sign counts times g, with the same two roundings: equal exactly
            if not exact:
                raise AssertionError(f"afcrps backward differs from its plain version: {abs_err}")
            if (m, dtype) == (TRAIN_M, "float32"):
                sign_ops = 3.0 * b * p * (m * m + m)  # sub, sign, add per term
                report["afcrps_bwd"] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                                        **_bound(2.0 * size * b * p * (m + 1), sign_ops,
                                                 "float32"),
                                        "library_ms": None}
            del ens, tgt, got, want
    torch.cuda.empty_cache()

    # D at the flagship's largest activation, NHWC bf16
    shape, p_drop = (BATCH, 128, 128, 32), 0.1
    x = randn(*shape).to(torch.bfloat16).requires_grad_()
    g = randn(*shape).to(torch.bfloat16)
    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    y = dropout.dropout(x, seed, p_drop)
    (dx,) = torch.autograd.grad(y, x, g)
    with torch.no_grad():
        want_y = dropout.dropout_plain(x, seed, p_drop)
        want_dx = dropout.dropout_plain(g, seed, p_drop)
    fwd_exact, bwd_exact = torch.equal(y, want_y), torch.equal(dx, want_dx)
    n = y.numel()
    keep = float((y != 0).float().mean())
    sigma = (p_drop * (1 - p_drop) / n) ** 0.5
    with torch.no_grad():
        xd = x.detach()
        ms = _sync_ms(lambda: dropout.dropout(xd, seed, p_drop), 20)
        plain_ms = _sync_ms(lambda: dropout.dropout_plain(xd, seed, p_drop), 3, 1)
        library_ms = _sync_ms(lambda: F.dropout(xd, p_drop, training=True), 20)
    print(f"kernel dropout         shape={shape} bf16 p={p_drop} fwd_exact={fwd_exact} "
          f"bwd_exact={bwd_exact} keep_rate={keep:.6f} (1-p={1 - p_drop}, "
          f"{abs(keep - (1 - p_drop)) / sigma:.2f} sigma) kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} F.dropout_ms={library_ms:.4f}")
    if not (fwd_exact and bwd_exact):
        raise AssertionError("dropout kernel masks differ from the plain version's")
    if not abs(keep - (1 - p_drop)) <= 5 * sigma:
        raise AssertionError(f"dropout keep rate {keep} is not within 5 sigma of {1 - p_drop}")
    # read x, write y; ~16 integer operations per element for the hash
    report["dropout"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         **_bound(2.0 * 2 * n, 16.0 * n, "float32"),
                         "library_ms": library_ms}
    del x, g, y, dx, want_y, want_dx, xd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    for i, case in enumerate(GN_CASES):
        rows = _gn_vs_plain(randn, dev, *case)
        if i == 0:
            report.update(rows)
        torch.cuda.empty_cache()
    return report


def _gn_vs_plain(randn, dev, shape, dtype, film: bool, p_drop: float) -> dict:
    """Kernels C and C′ against their plain versions at one shape: every
    output and the masks, each kernel on its planned route and on the
    other one (for C the three passes where the plan takes a cluster and
    the shape's cluster layout where it takes three passes; for C′ two
    passes or the cluster layout), each run twice for identical bits;
    times, bounds, and ``F.group_norm``'s time at the shape as a note (it
    computes only the normalization, not the chain, so it is no
    ``library_ms``)."""
    b, h, w, c = shape
    groups = min(32, c // 4)
    tdt = getattr(torch, dtype)
    size = torch.finfo(tdt).bits // 8
    n = b * h * w * c
    x, g = (randn(*shape) + 0.5).to(tdt), randn(*shape).to(tdt)
    gamma, beta = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
    if film:
        scale, shift = randn(b, c, scale=0.2), randn(b, c, scale=0.2)
    else:  # norm0: scale = shift = 0
        scale = shift = torch.zeros(b, c, device=dev)
    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    args = (x, gamma, beta, scale, shift, seed)
    consts = (groups, 1e-5, p_drop, True)
    want = fused_gn.gn_film_silu_dropout_plain(*args, *consts)
    plan = fused_gn.fwd_plan(h * w, c, groups, size)
    fwd = [_gn_fwd_route(args, consts, want, pl)
           for pl in ((plan,) if plan == fused_gn.THREE_PASS else (plan, fused_gn.THREE_PASS))]
    y, mean, rstd = fwd[0].pop("result")
    for r in fwd[1:]:
        del r["result"]
    # the public entry takes the planned route
    if not torch.equal(fused_gn.gn_film_silu_dropout_fwd(*args, *consts)[0], y):
        raise AssertionError("kernel C's entry point left its planned route")
    # the backward of both on the kernel's statistics: C′ on the shape's plan
    # and on the other route, each held to the plain version
    bwd_args = (x, g, gamma, beta, scale, shift, seed, mean, rstd, groups, p_drop, True)
    want_bwd = fused_gn.gn_film_silu_dropout_bwd_plain(*bwd_args)
    plan = fused_gn.bwd_plan(h * w, c, groups, size)
    other = (fused_gn.TWO_PASS if plan["route"] == "cluster"
             else fused_gn.cluster_plan(h * w, c, groups, size))
    routes = [_gn_bwd_route(bwd_args, want_bwd, pl) for pl in (plan, other) if pl is not None]
    plain_ms = _sync_ms(lambda: fused_gn.gn_film_silu_dropout_plain(*args, *consts), 2, 1)
    bwd_plain_ms = _sync_ms(lambda: fused_gn.gn_film_silu_dropout_bwd_plain(*bwd_args), 2, 1)
    xr = x.detach().permute(0, 3, 1, 2).requires_grad_()  # NCHW view, channels_last
    wr, br = gamma.to(tdt).requires_grad_(), beta.to(tdt).requires_grad_()
    gr = g.permute(0, 3, 1, 2)
    with torch.no_grad():
        gn_ms = _sync_ms(lambda: F.group_norm(xr, groups, wr, br, 1e-5), 20)
    gn_fb_ms = _sync_ms(lambda: torch.autograd.grad(F.group_norm(xr, groups, wr, br, 1e-5),
                                                    (xr, wr, br), gr), 10)
    # bytes: read x, write y (C); read x and g, write dx (C′); the (C,) and
    # (B, C) vectors and (B, G) statistics once each. Operations per
    # element: ~10 f32 (statistics, affine, SiLU) forward and ~30 backward,
    # ~16 integer operations for the mask where p > 0 (as D's count)
    vec_bytes = 4.0 * (2 * c + 2 * b * c + 2 * b * groups)
    hash_ops = 16.0 if p_drop > 0 else 0.0
    fwd_bound = _bound(2.0 * size * n + vec_bytes, (10.0 + hash_ops) * n, "float32")
    bwd_bound = _bound(3.0 * size * n + vec_bytes + 4.0 * 2 * b * c, (30.0 + hash_ops) * n,
                       "float32")
    for i, r in enumerate(fwd):
        print(f"kernel fused_gn        shape={shape} {dtype:8s} film={film} p={p_drop} "
              f"{'planned' if i == 0 else 'other  '} plan={json.dumps(r['plan'])} "
              f"bit_reproducible=True masks_equal={r['masks_equal']} "
              f"kept_zeros={r['kept_zeros']} keep_rate={r['keep']:.6f} "
              f"max_err/max={json.dumps(r['err'])} max_abs_err={r['abs_err']:.3e} "
              f"kernel_ms={r['ms']:.4f} no_silu_no_mask_ms={r['bare_ms']:.4f}")
    print(f"kernel fused_gn        shape={shape} {dtype:8s} plain_ms={plain_ms:.4f} "
          f"bound_ms={fwd_bound['bound_ms']:.4f} ({fwd_bound['bound_by']}) "
          f"F.group_norm_ms={gn_ms:.4f}")
    for i, r in enumerate(routes):
        print(f"kernel fused_gn_bwd    shape={shape} {dtype:8s} film={film} p={p_drop} "
              f"{'planned' if i == 0 else 'other  '} plan={json.dumps(r['plan'])} "
              f"bit_reproducible=True max_err/max={json.dumps(r['err'])} "
              f"max_abs_err={r['abs_err']:.3e} kernel_ms={r['ms']:.4f} "
              f"no_silu_no_mask_ms={r['bare_ms']:.4f}")
    print(f"kernel fused_gn_bwd    shape={shape} {dtype:8s} plain_ms={bwd_plain_ms:.4f} "
          f"bound_ms={bwd_bound['bound_ms']:.4f} ({bwd_bound['bound_by']}) "
          f"F.group_norm_fwd+bwd_ms={gn_fb_ms:.4f}")
    errs = {**{f"{k} (C {r['plan']['route']})": e for r in fwd for k, e in r["err"].items()},
            **{f"{k} (C′ {r['plan']['route']})": e for r in routes for k, e in r["err"].items()}}
    bad = {k: e for k, e in errs.items()
           if not e <= (GN_TOL[dtype] if k.split()[0] in ("y", "dx") else GN_SUM_TOL)}
    bad.update({f"masks (C {r['plan']['route']})": "differ" for r in fwd if not r["masks_equal"]})
    keep = fwd[0]["keep"]
    if p_drop > 0 and not abs(keep - (1 - p_drop)) <= 5 * (p_drop * (1 - p_drop) / n) ** 0.5:
        bad["keep_rate"] = keep
    if bad:
        raise AssertionError(f"fused_gn kernels disagree with their plain versions at {shape} "
                             f"{dtype}: {bad}")
    return {"fused_gn": {"max_abs_err": fwd[0]["abs_err"], "ms": fwd[0]["ms"],
                         "plain_ms": plain_ms, **fwd_bound, "library_ms": None},
            "fused_gn_bwd": {"max_abs_err": routes[0]["abs_err"], "ms": routes[0]["ms"],
                             "plain_ms": bwd_plain_ms, **bwd_bound, "library_ms": None}}


def _cluster_occupancy(forward: bool, x: torch.Tensor, plan: dict) -> int:
    """Clusters of a cluster-route plan the card holds at once."""
    clusters = ctypes.c_int(0)
    _build.check(_build.library().fused_gn_cluster_occupancy(
        int(forward), x.shape[-1], plan["part_channels"], plan["cluster"], plan["iters"],
        int(x.dtype == torch.bfloat16), ctypes.addressof(clusters)), "fused_gn_cluster_occupancy")
    return clusters.value


def _gn_fwd_route(args, consts, want, plan: dict) -> dict:
    """Kernel C on one plan of its shape: run twice for identical bits; y,
    mean, rstd and the dropout mask against the plain forward; its time,
    and its time with the chain's SiLU and mask off (the route's memory
    traffic and structure alone). ``result`` holds its outputs."""
    def run(cs=consts):
        return fused_gn._launch(*args, *cs, plan=plan)

    got, again = run(), run()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"kernel C is not bit-reproducible on plan {plan}")
    y, p_drop = got[0], consts[2]
    # the kernel's mask is the plain one: every element the plain mask drops
    # is 0, and a kept element is 0 only where z is (SiLU(0) = 0), which
    # takes ~1e-8 of them; a kernel that dropped other elements would zero
    # ~p of the kept ones
    dropped = (~fused_gn.gn_keep(y.shape, args[5], p_drop) if p_drop > 0
               else torch.zeros_like(y, dtype=torch.bool))
    kept_zeros = int(((y == 0) & ~dropped).sum())
    out = {"plan": dict(plan), "result": got,
           "err": {k: _max_err_ratio(u.float(), v.float())
                   for k, u, v in zip(("y", "mean", "rstd"), got, want)},
           "abs_err": float((y.float() - want[0].float()).abs().max()),
           "masks_equal": bool((y[dropped] == 0).all()) and kept_zeros <= 1e-6 * y.numel(),
           "kept_zeros": kept_zeros, "keep": float((y != 0).float().mean()),
           "ms": _sync_ms(run, 20),
           "bare_ms": _sync_ms(lambda: run((consts[0], consts[1], 0.0, False)), 20)}
    del dropped
    if plan["route"] == "cluster":
        out["plan"]["clusters_resident"] = _cluster_occupancy(True, args[0], plan)
    return out


def gn_fwd_routes(dev, chains) -> None:
    """Kernel C at every chain shape of the flagship U-Net (bf16, bs=128,
    FiLM, p=0.1) on both routes, the three passes and the planned cluster
    layout, and on every other cluster layout of the shape (the ``C
    layouts`` lines): each run twice for identical bits and held to the
    plain forward, with their times, and the sums over a forward's 57
    chains. These are the timings ``fused_gn.fwd_plan``'s rule follows."""
    gen = torch.Generator(device=dev).manual_seed(4322)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    per_step = {"planned": 0.0, "three_pass": 0.0}
    for (h, w, c, groups), count in sorted(collections.Counter(chains).items()):
        shape = (BATCH, h, w, c)
        x = (randn(*shape) + 0.5).to(torch.bfloat16)
        args = (x, 1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(BATCH, c, scale=0.2),
                randn(BATCH, c, scale=0.2), seed)
        consts = (groups, 1e-5, 0.1, True)
        want = fused_gn.gn_film_silu_dropout_plain(*args, *consts)
        plan = fused_gn.fwd_plan(h * w, c, groups, 2)
        routes = {"planned": plan, "three_pass": fused_gn.THREE_PASS}
        routes.update({f"layout{i}": la for i, la in enumerate(fused_gn.cluster_layouts(
            h * w, c, groups, 2, fused_gn.fwd_cluster_smem_bytes, fused_gn.FWD_REGISTER_BLOCKS))
            if la != plan})
        runs = {name: _gn_fwd_route(args, consts, want, pl) for name, pl in routes.items()}
        for r in runs.values():
            del r["result"]
        bad = {f"{k} ({route})": e for route, r in runs.items() for k, e in r["err"].items()
               if not e <= (GN_TOL["bfloat16"] if k == "y" else GN_SUM_TOL)}
        bad.update({f"masks ({route})": "differ" for route, r in runs.items()
                    if not r["masks_equal"]})
        if bad:
            raise AssertionError(f"kernel C disagrees with its plain version at {shape}: {bad}")
        ms = {route: r["ms"] for route, r in runs.items()}
        per_step["planned"] += count * ms["planned"]
        per_step["three_pass"] += count * ms["three_pass"]
        print(f"C routes shape={shape} chains={count} planned={plan['route']} "
              f"planned_ms={ms['planned']:.4f} three_pass_ms={ms['three_pass']:.4f} "
              f"plan={json.dumps(runs['planned']['plan'])} bit_reproducible=True "
              f"max_err/max(y)={max(r['err']['y'] for r in runs.values()):.3e}")
        for route, r in runs.items():
            if route.startswith("layout"):
                print(f"C layouts shape={shape} plan={json.dumps(r['plan'])} "
                      f"kernel_ms={r['ms']:.4f} no_silu_no_mask_ms={r['bare_ms']:.4f}")
        del x, args, want, runs
    print(f"C over one forward's {len(chains)} chains (ms, sum of the shapes' times): "
          f"{json.dumps(per_step)}")
    torch.cuda.empty_cache()


def _gn_bwd_route(bwd_args, want, plan: dict) -> dict:
    """Kernel C′ on one plan of its shape: run twice for identical bits,
    every output against the plain backward, its time, and its time with
    the chain's SiLU and mask off (the route's memory traffic and
    structure alone)."""
    def run(args=bwd_args):
        return fused_gn._launch_bwd(*args, plan=plan)

    got, again = run(), run()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"kernel C′ is not bit-reproducible on plan {plan}")
    names = ("dx", "dgamma", "dbeta", "dscale", "dshift")
    out = {"plan": dict(plan),
           "err": {k: _max_err_ratio(u.float(), v.float()) for k, u, v in zip(names, got, want)},
           "abs_err": max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want)),
           "ms": _sync_ms(run, 20),
           "bare_ms": _sync_ms(lambda: run((*bwd_args[:10], 0.0, False)), 20)}
    if plan["route"] == "cluster":
        out["plan"]["clusters_resident"] = _cluster_occupancy(False, bwd_args[0], plan)
    return out


def gn_bwd_routes(dev, chains) -> None:
    """Kernel C′ at every chain shape of the flagship U-Net (bf16, bs=128,
    FiLM, p=0.1) on both routes, two passes and the shape's cluster
    layout: each run twice for identical bits and held to the plain
    backward, with both times, and the sums over a training step's 57
    chains. These are the timings ``fused_gn.bwd_plan``'s rule follows."""
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    per_step = {"planned": 0.0, "two_pass": 0.0, "cluster": 0.0}
    for (h, w, c, groups), count in sorted(collections.Counter(chains).items()):
        shape = (BATCH, h, w, c)
        x, g = (randn(*shape) + 0.5).to(torch.bfloat16), randn(*shape).to(torch.bfloat16)
        gamma, beta = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
        scale, shift = randn(BATCH, c, scale=0.2), randn(BATCH, c, scale=0.2)
        _, mean, rstd = fused_gn.gn_film_silu_dropout_fwd(x, gamma, beta, scale, shift, seed,
                                                          groups, 1e-5, 0.1, True)
        bwd_args = (x, g, gamma, beta, scale, shift, seed, mean, rstd, groups, 0.1, True)
        want = fused_gn.gn_film_silu_dropout_bwd_plain(*bwd_args)
        plan = fused_gn.bwd_plan(h * w, c, groups, 2)
        layout = fused_gn.cluster_plan(h * w, c, groups, 2)
        runs = {"two_pass": _gn_bwd_route(bwd_args, want, fused_gn.TWO_PASS)}
        if layout is not None:
            runs["cluster"] = _gn_bwd_route(bwd_args, want, layout)
        bad = {f"{k} ({route})": e for route, r in runs.items() for k, e in r["err"].items()
               if not e <= (GN_TOL["bfloat16"] if k == "dx" else GN_SUM_TOL)}
        if bad:
            raise AssertionError(f"kernel C′ disagrees with its plain version at {shape}: {bad}")
        ms = {route: r["ms"] for route, r in runs.items()}
        per_step["planned"] += count * ms[plan["route"]]
        per_step["two_pass"] += count * ms["two_pass"]
        per_step["cluster"] += count * ms.get("cluster", ms["two_pass"])
        print(f"C′ routes shape={shape} chains={count} planned={plan['route']} "
              f"two_pass_ms={ms['two_pass']:.4f} cluster_ms={ms.get('cluster', float('nan')):.4f} "
              f"layout={json.dumps(runs.get('cluster', {}).get('plan'))} bit_reproducible=True "
              f"max_err/max(dx)={max(r['err']['dx'] for r in runs.values()):.3e}")
        del x, g, want, runs
    print(f"C′ over one training step's {len(chains)} chains (ms, sum of the shapes' times): "
          f"{json.dumps(per_step)}")
    torch.cuda.empty_cache()


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


def train_device_vs_cpu(model32: ProbabilisticUNet, hr: torch.Tensor, stats, cfg,
                        dev: torch.device) -> None:
    """The f32 training step on the card (kernels A, A′, D and B, B′ on
    the unfused route) against the CPU (plain versions): two items,
    dropout 0.1, the same noise and seed words, beta_1 = 1. Loss and every
    parameter's gradient, then the parameters after one AdamW step."""
    eps = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (cfg.train.ensemble_size, 2, cfg.model.latent_dim)).astype(np.float32))
    seeds = torch.from_numpy(np.random.default_rng(12).integers(
        -2 ** 31, 2 ** 31, (len(model32.unet.dropout_blocks), 2), dtype=np.int32))
    for fused in (True, False):
        out = {}
        for where in ("cpu", dev):
            model = copy.deepcopy(model32)
            state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                                       weight_decay=cfg.train.weight_decay, device=where)
            st = type(stats)(*[t.to(where) for t in stats])
            batch = preprocess_batch(hr[:2].to(where), st, cfg.data.pipeline,
                                     cfg.data.lowres_scale, cfg.data.interp_mode,
                                     cfg.data.epsilon, cfg.data.standardization)
            total, _ = model.elbo(batch["inputs"], batch["targets"], M=cfg.train.ensemble_size,
                                  beta_1=1.0, eps=eps.to(where), fused=fused, training=True,
                                  seeds=seeds.to(where))
            grads = torch.autograd.grad(total, state.optimizer.params)
            if where == "cpu" and fused:
                # the gradients' own sensitivity: the CPU step again on
                # inputs moved by a relative 1e-6
                noise = torch.randn(batch["inputs"].shape,
                                    generator=torch.Generator().manual_seed(13))
                moved, _ = model.elbo(batch["inputs"] * (1 + 1e-6 * noise), batch["targets"],
                                      M=cfg.train.ensemble_size, beta_1=1.0, eps=eps,
                                      fused=True, training=True, seeds=seeds)
                errs = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in
                        zip(torch.autograd.grad(moved, state.optimizer.params), grads)]
                print(f"cpu f32 train step, inputs moved by 1e-6 relative: gradients "
                      f"||dg||/||g|| median={float(np.median(errs)):.3e} max={max(errs):.3e}")
            state.optimizer.step(list(grads))
            out[str(where)] = (float(total.detach()), [g.cpu() for g in grads],
                               [p.detach().cpu() for p in state.optimizer.params])
            del model, state, grads, total
        # the card's update on its own gradients, redone by the CPU optimizer
        redo = create_train_state(copy.deepcopy(model32), seed=cfg.train.seed, lr=cfg.train.lr,
                                  weight_decay=cfg.train.weight_decay, device="cpu")
        redo.optimizer.step(out[str(dev)][1])
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(dev)]
        rel = abs(lg - lc) / abs(lc)
        names = [n for n, _ in model32.named_parameters()]
        grad_err = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for n, a, b in zip(names, gg, gc)}
        worst = max(grad_err, key=grad_err.get)
        lr = cfg.train.lr
        step_diff = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
        flipped = float((step_diff > lr).float().mean())
        redo_err = max(float((a - b.detach()).abs().max())
                       for a, b in zip(pg, redo.optimizer.params))
        print(f"device vs cpu f32 train step fused={fused}: loss cuda={lg:.7g} cpu={lc:.7g} "
              f"rel_err={rel:.3e}; grads ||dg||/||g|| max={grad_err[worst]:.3e} ({worst}), "
              f"median={float(np.median(list(grad_err.values()))):.3e}; after AdamW: "
              f"vs the CPU optimizer on the card's gradients max|dp|={redo_err:.3e}; "
              f"vs the CPU step max|dp|={float(step_diff.max()):.3e} (lr={lr}), "
              f"mean|dp|={float(step_diff.mean()):.3e}, share stepped the other way "
              f"(|dp|>lr): {flipped:.3e}")
        if not rel <= DEVICE_RTOL:
            raise AssertionError(f"training loss on the card differs from the CPU: {rel}")
        if not grad_err[worst] <= GRAD_RTOL:
            raise AssertionError(f"gradient of {worst} differs from the CPU: {grad_err[worst]}")
        # the same update from the same gradients: one or two f32 roundings
        if not redo_err <= 1e-6:
            raise AssertionError(f"the card's AdamW step differs from the CPU's: {redo_err}")
        if not flipped <= FLIP_SHARE:
            raise AssertionError(f"{flipped} of the weights stepped the other way than on "
                                 f"the CPU (limit {FLIP_SHARE})")


def _train_route(model: ProbabilisticUNet, batches, stats, cfg, dev, fused: bool,
                 name: str) -> dict:
    """Warm-up and timed training steps on one route; halves the batch
    while it does not fit on the card."""
    bs = TRAIN_BATCH
    while True:
        state = create_train_state(copy.deepcopy(model), seed=cfg.train.seed, lr=cfg.train.lr,
                                   weight_decay=cfg.train.weight_decay, device=dev)
        step = make_train_step(state.model, cfg, fused=fused)
        before = [p.detach().clone() for p in state.optimizer.params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            mets = []
            for i in range(TRAIN_WARMUP):
                state, met = step(state, batches[i % len(batches)][:bs], stats, 1.0, 1.0)
                mets.append(met)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(TRAIN_STEPS):
                state, met = step(state, batches[i % len(batches)][:bs], stats, 1.0, 1.0)
                mets.append(met)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            break
        except torch.OutOfMemoryError:
            del state, step, before
            torch.cuda.empty_cache()
            if bs == 1:
                raise
            print(f"train {name}: bs={bs} does not fit, halving")
            bs //= 2
    vals = [{k: float(v) for k, v in m.items()} for m in mets]
    if not all(math.isfinite(v) for m in vals for v in m.values()):
        raise AssertionError(f"non-finite training metrics: {vals}")
    changed = sum(not torch.equal(a, b) for a, b in zip(before, state.optimizer.params))
    if changed != len(before):
        raise AssertionError(f"only {changed} of {len(before)} parameters changed")
    res = {"batch": bs, "samples_per_s": TRAIN_STEPS * bs / dt, "step_ms": dt / TRAIN_STEPS * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [m["loss"] for m in vals]}
    print(f"train {name} bs={bs} M={cfg.train.ensemble_size}: " + " ".join(
        f"step{i}: loss={m['loss']:.9g} recon={m['recon']:.6g} kl={m['kl_mean']:.6g} "
        f"grad_norm={m['grad_norm']:.6g};" for i, m in enumerate(vals)))
    print(f"train {name}: samples/s={res['samples_per_s']:.2f} "
          f"step_ms={res['step_ms']:.3f} peak_memory_gb={res['peak_gb']:.3f}"
          + ("" if bs == TRAIN_BATCH else f" (bs={TRAIN_BATCH} did not fit)"))
    del state, step, before
    torch.cuda.empty_cache()
    return res


_KERNEL_GROUPS = (("A fcomb_crps fwd", ("fcomb_crps_fwd_mma_kernel", "fcomb_crps_tile_kernel",
                                       "reduce_partials")),
                  ("A' fcomb_crps bwd", ("fcomb_crps_bwd_mma_kernel", "fcomb_crps_bwd_tile_kernel",
                                         "column_sum_kernel")),
                  ("B afcrps fwd", ("afcrps_tile_kernel",)),
                  ("B' afcrps bwd", ("afcrps_bwd_kernel",)),
                  ("C fused_gn fwd", ("gn_fwd_",)),
                  ("C' fused_gn bwd", ("gn_bwd_",)),
                  ("D dropout", ("dropout_kernel",)),
                  ("AdamW (foreach)", ("multi_tensor_apply", "foreach")),
                  ("cuDNN/cuBLAS (convs, matmuls)", ("cudnn", "xmma", "gemm", "conv", "cutlass")))


def _kernel_ms_by_group(run, n: int) -> tuple[dict, dict, float]:
    """torch.profiler's device time per call of ``run`` (n calls), by the
    kernel families of _KERNEL_GROUPS: (ms by group, ms by kernel of the
    rest, total ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    groups = {g: 0.0 for g, _ in _KERNEL_GROUPS}
    other, total = {}, 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.self_cpu_time_total != 0 or dev_us <= 0:
            continue
        total += dev_us
        for g, keys in _KERNEL_GROUPS:
            if any(k in e.key for k in keys):
                groups[g] += dev_us
                break
        else:
            other[e.key] = other.get(e.key, 0.0) + dev_us
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return ({g: v / (1e3 * n) for g, v in groups.items()},
            {k: v / (1e3 * n) for k, v in other.items()}, total / (1e3 * n))


def _print_groups(what: str, groups: dict, other: dict, total: float, step_ms: float) -> None:
    print(f"{what} kernel ms/step (torch.profiler, 2 steps): "
          + " ".join(f"{g}={v:.3f}" for g, v in groups.items() if v > 0)
          + f" other={sum(other.values()):.3f} total={total:.3f} "
          f"idle_share={1 - total / step_ms:.4f}")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:8]
    print(f"{what} largest other kernels (ms/step): "
          + "; ".join(f"{k[:90]}={v:.3f}" for k, v in top))


def serve_breakdown(model: ProbabilisticUNet, hr: torch.Tensor, stats, cfg, dev,
                    name: str) -> None:
    """Where the eval step's time goes (bs=128, M=5, fused): CUDA events
    around the step, the U-Net forward and the prior ensemble's ``sample``
    (M=16); torch.profiler's kernel time by family over two steps."""
    step = make_eval_step(model, cfg, fused=True)
    gen = torch.Generator(device=dev).manual_seed(6)
    batch = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    step_ms = _sync_ms(lambda: step(hr, stats, gen), 3, 1, spin=False)
    with torch.no_grad():
        unet_ms = _sync_ms(lambda: model.unet(batch["inputs"]), 3, 1, spin=False)
        sample_ms = _sync_ms(lambda: model.sample(batch["inputs"], ENSEMBLE_M, generator=gen),
                             3, 1, spin=False)
    print(f"serve breakdown {name} bs={hr.shape[0]} (CUDA events, ms): eval_step={step_ms:.3f} "
          f"unet_fwd={unet_ms:.3f} sample_M{ENSEMBLE_M}={sample_ms:.3f}")
    _print_groups(f"serve breakdown {name} eval step",
                  *_kernel_ms_by_group(lambda: step(hr, stats, gen), 2), step_ms)


def train_breakdown(model: ProbabilisticUNet, hr: torch.Tensor, stats, cfg, dev,
                    fused: bool, bs: int, name: str) -> None:
    """Where one training step's time goes: CUDA events around the U-Net
    forward and backward, the whole loss, its backward and the AdamW step;
    torch.profiler's kernel time by kernel family over two steps; the
    device's idle share (1 - kernel time / elapsed)."""
    state = create_train_state(copy.deepcopy(model), seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device=dev)
    step = make_train_step(state.model, cfg, fused=fused)
    hr = hr[:bs]
    batch = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    gen = torch.Generator(device=dev).manual_seed(5)
    unet = state.model.unet
    feats = unet(batch["inputs"], train=True, generator=gen)
    cot = torch.randn_like(feats)
    del feats
    unet_fwd = _sync_ms(lambda: unet(batch["inputs"], train=True, generator=gen), 3, 1, spin=False)
    unet_fb = _sync_ms(lambda: torch.autograd.backward(
        unet(batch["inputs"], train=True, generator=gen), cot), 3, 1, spin=False)
    params = state.optimizer.params

    def loss():
        return state.model.elbo(batch["inputs"], batch["targets"], M=cfg.train.ensemble_size,
                                beta_1=1.0, generator=gen, fused=fused, training=True)[0]

    loss_ms = _sync_ms(lambda: loss(), 3, 1, spin=False)
    loss_bwd = _sync_ms(lambda: torch.autograd.grad(loss(), params), 3, 1, spin=False)
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    adamw_ms = _sync_ms(lambda: state.optimizer.step(grads), 5, 1, spin=False)
    step_ms = _sync_ms(lambda: step(state, hr, stats, 1.0, 1.0), 3, 1, spin=False)
    print(f"train breakdown {name} bs={bs} (CUDA events, ms): step={step_ms:.3f} "
          f"loss_fwd={loss_ms:.3f} loss_fwd+bwd={loss_bwd:.3f} unet_fwd={unet_fwd:.3f} "
          f"unet_fwd+bwd={unet_fb:.3f} adamw={adamw_ms:.3f}")
    _print_groups(f"train breakdown {name}",
                  *_kernel_ms_by_group(lambda: step(state, hr, stats, 1.0, 1.0), 2), step_ms)
    del state, step, grads, cot
    torch.cuda.empty_cache()


def _chain_layouts(model: ProbabilisticUNet, run) -> dict:
    """Counts, over one call of ``run``, of the GroupNorm chains whose input
    (forward) or output gradient (backward) is not channels_last in memory:
    for those the kernel route's NHWC ``contiguous()`` copies the tensor."""
    counts = {"inputs": 0, "inputs_copied": 0, "grads": 0, "grads_copied": 0}

    def pre(_, args):
        counts["inputs"] += 1
        counts["inputs_copied"] += not args[0].is_contiguous(memory_format=torch.channels_last)

    def on_grad(g):
        counts["grads"] += 1
        counts["grads_copied"] += not g.is_contiguous(memory_format=torch.channels_last)

    def post(_, args, out):
        if out.requires_grad:
            out.register_hook(on_grad)

    norms = [m for m in model.unet.modules() if isinstance(m, EDMGroupNorm)]
    hooks = [m.register_forward_pre_hook(pre) for m in norms]
    hooks += [m.register_forward_hook(post) for m in norms]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return counts


def remat_grads(model: ProbabilisticUNet, remats: dict, batch: dict, cfg, dev) -> dict:
    """One training step's loss and gradients on the same batch, noise and
    dropout seed words for each model of ``remats`` (name -> the same
    weights under a remat mode) against ``model`` without remat: max over
    parameters of ||g - g_plain|| / ||g_plain||. Under remat the backward
    relaunches kernel C and regenerates its masks from the saved seed
    words, so this is what checks the recompute. The same measure for
    ``model`` run again (the card's run-to-run noise: cuDNN's
    weight-gradient sums need not be bit-identical) and for ``model`` with
    the seed words of one dropout block changed (what a recompute with a
    wrong mask gives)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    seeds = dropout_seeds(gen, len(model.unet.dropout_blocks))
    eps = torch.randn((cfg.train.ensemble_size, batch["inputs"].shape[0],
                       cfg.model.latent_dim), generator=gen, device=dev)

    def grads(m, s):
        params = list(m.parameters())
        loss = m.elbo(batch["inputs"], batch["targets"], M=cfg.train.ensemble_size,
                      beta_1=1.0, eps=eps, fused=True, training=True, seeds=s)[0]
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return float(loss.detach()), [
            torch.zeros_like(p) if g is None else g.float() for p, g in zip(params, gs)]

    def worst(gs, ref):
        return max(float((a - b).norm() / b.norm()) for a, b in zip(gs, ref) if b.norm() > 0)

    loss0, ref = grads(model, seeds)
    wrong = seeds.clone()
    wrong[0, 0] ^= 1
    out = {"noise": worst(grads(model, seeds)[1], ref),
           "wrong_mask": worst(grads(model, wrong)[1], ref)}
    for name, m in remats.items():
        loss, gs = grads(m, seeds)
        out[name] = worst(gs, ref)
        if loss != loss0:
            raise AssertionError(f"{name}: loss {loss!r} vs {loss0!r} without remat")
    torch.cuda.empty_cache()
    return out


def _variant(model: ProbabilisticUNet, cfg, gn_impl: str = "kernel",
             remat=False) -> ProbabilisticUNet:
    """``model`` rebuilt on another GroupNorm route or remat mode (from the
    config, as a user builds it), with the same weights, on its device."""
    cfg = copy.deepcopy(cfg)
    if isinstance(remat, tuple):
        cfg.train.remat, cfg.train.remat_levels = False, remat
    else:
        cfg.train.remat, cfg.train.remat_levels = remat, ()
    out = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device="cpu",
                                        gn_impl=gn_impl)
    out.load_state_dict(model.state_dict())
    return out.to(next(model.parameters()).device).eval()


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
    for name, res in _ptxas_report(info["log"], PTXAS_KERNELS).items():
        print(f"ptxas {name}: {json.dumps(res)}")

    report = kernels_vs_plain(dev)

    cfg = preset("probunet_multivar_128")
    cfg.model.compute_dtype = "bfloat16"     # as bench.py runs it
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
    model = ProbabilisticUNet.from_config(cfg, gen, device="cpu")  # GroupNorm: kernels C, C′
    _fill_zero_params(model, gen)
    cfg32 = preset("probunet_multivar_128")
    model32 = ProbabilisticUNet.from_config(cfg32, torch.Generator().manual_seed(0),
                                            device="cpu")
    model32.load_state_dict(model.state_dict())
    hr_cpu, stats_cpu = hr.cpu(), type(stats)(*[t.cpu() for t in stats])
    device_vs_cpu(model32.eval(), hr_cpu, stats_cpu, cfg32, dev)
    train_device_vs_cpu(model32, hr_cpu, stats_cpu, cfg32, dev)
    del model32
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: probunet_multivar_128 bf16, {n_params} parameters")

    counters = {"fcomb_crps": fcomb_crps.fcomb_crps_terms,
                "fcomb_crps_bwd": fcomb_crps.fcomb_crps_terms_bwd,
                "afcrps": afcrps.ensemble_crps_terms,
                "afcrps_bwd": afcrps.ensemble_crps_terms_bwd,
                "fused_gn": fused_gn.gn_film_silu_dropout,
                "fused_gn_bwd": fused_gn.gn_film_silu_dropout_bwd,
                "dropout": dropout.dropout}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in counters.items()}

    # the serve path: eval ELBO fused and unfused, prior ensemble; every
    # GroupNorm chain of every U-Net forward through kernel C
    unet_calls = [0]
    hook = model.unet.register_forward_hook(
        lambda *_: unet_calls.__setitem__(0, unet_calls[0] + 1))
    zero_counts()
    rates = serve(model, batches, stats, cfg, dev)
    serve_launches = read_counts()
    hook.remove()
    chains = 2 * len(model.unet.dropout_blocks) + 1
    print(f"launches on the serve path ({unet_calls[0]} U-Net forwards, {chains} GroupNorm "
          f"chains each): {json.dumps(serve_launches)}; rates: {json.dumps(rates)}")
    for name in ("fcomb_crps", "afcrps", "fused_gn"):
        if serve_launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the serve path")
    if chains != 57 or serve_launches["fused_gn"] != chains * unet_calls[0]:
        raise AssertionError(f"{serve_launches['fused_gn']} C launches for {unet_calls[0]} "
                             f"U-Net forwards of {chains} chains: a chain left kernel C")
    # the chains' bytes: C reads x and writes y, C′ reads x and g and writes dx
    x_bytes, chain_shapes = [], []

    def chain_hook(mod, a):
        x_bytes.append(a[0].numel() * a[0].element_size())
        chain_shapes.append((a[0].shape[2], a[0].shape[3], a[0].shape[1], mod.groups))

    hooks = [mod.register_forward_pre_hook(chain_hook)
             for mod in model.unet.modules() if isinstance(mod, EDMGroupNorm)]
    with torch.no_grad():
        model.unet(preprocess_batch(batches[0], stats, cfg.data.pipeline, cfg.data.lowres_scale,
                                    cfg.data.interp_mode, cfg.data.epsilon,
                                    cfg.data.standardization)["inputs"])
    for h in hooks:
        h.remove()
    print(f"GroupNorm chains of one U-Net forward (bs={BATCH}): {len(x_bytes)} chains, x "
          f"{sum(x_bytes) / 1e9:.4f} GB; bounds: C {2 * sum(x_bytes) / H100_BYTES_PER_S * 1e3:.4f} "
          f"ms, C′ {3 * sum(x_bytes) / H100_BYTES_PER_S * 1e3:.4f} ms (bytes at 3.35 TB/s)")
    gn_fwd_routes(dev, chain_shapes)
    gn_bwd_routes(dev, chain_shapes)
    model_composed = _variant(model, cfg, gn_impl="composed")
    for name, m in (("kernel", model), ("composed", model_composed)):
        serve_breakdown(m, batches[0], stats, cfg, dev, name)

    # the training path: bs=128, M=15, dropout 0.1, on six routes
    cfg_train = copy.deepcopy(cfg)
    cfg_train.train.ensemble_size = TRAIN_M
    kernel_fused = "kernel fused"
    remats = {f"kernel fused remat={r}": (_variant(model, cfg, remat=r), True)
              for r in REMAT_MODES}
    routes = {kernel_fused: (model, True), "kernel unfused": (model, False),
              "composed fused": (model_composed, True), **remats}
    zero_counts()
    train = {name: _train_route(m, batches, stats, cfg_train, dev, fused, name)
             for name, (m, fused) in routes.items()}
    launches = read_counts()
    n_steps = len(routes) * (TRAIN_WARMUP + TRAIN_STEPS)
    print(f"launches on the training path ({n_steps} steps on {len(routes)} routes): "
          f"{json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    plain = train[kernel_fused]
    for name in remats:
        r = train[name]
        print(f"{name}: losses {r['losses'][:2]!r} vs {plain['losses'][:2]!r} without remat; "
              f"peak memory {r['peak_gb']:.3f} vs {plain['peak_gb']:.3f} GB")
        if r["batch"] != plain["batch"] or r["losses"][0] != plain["losses"][0]:
            raise AssertionError(f"{name} changed the training loss")
    bs = plain["batch"]
    batch = preprocess_batch(batches[0][:bs], stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    layouts = _chain_layouts(model, lambda: torch.autograd.grad(model.elbo(
        batch["inputs"], batch["targets"], M=TRAIN_M, beta_1=1.0, fused=True, training=True,
        generator=torch.Generator(device=dev).manual_seed(8))[0], list(model.parameters()),
        allow_unused=True))
    print(f"GroupNorm chains of one training step on the kernel route, not channels_last "
          f"(copied to NHWC): {json.dumps(layouts)}")
    errs = remat_grads(model, {name: m for name, (m, _) in remats.items()}, batch,
                       cfg_train, dev)
    print(f"gradients of one training step (bs={bs}) vs no remat, max over parameters of "
          f"||g - g_plain|| / ||g_plain||: {json.dumps(errs)} (limit {REMAT_GRAD_RTOL})")
    if not errs["wrong_mask"] > REMAT_GRAD_RTOL:
        raise AssertionError("one block's wrong dropout mask stays within the remat limit: "
                             "the check cannot see it")
    for name in remats:
        if not errs[name] <= REMAT_GRAD_RTOL:
            raise AssertionError(f"{name} changed the gradients: {errs[name]}")
    for name, (m, fused) in routes.items():
        train_breakdown(m, batches[0], stats, cfg_train, dev, fused, train[name]["batch"], name)
    print("train rates: " + json.dumps(
        {name: {k: v for k, v in r.items() if k != "losses"} for name, r in train.items()}))

    modules = {"fcomb_crps": fcomb_crps, "afcrps": afcrps, "fused_gn": fused_gn,
               "dropout": dropout}
    kernels = []
    for name in counters:
        mod = modules[name.removesuffix("_bwd")]
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES_BWD if name.endswith("_bwd") else mod.REPLACES,
                        "launches": launches[name], **report[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
