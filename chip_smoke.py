#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``probunet_tpu_torch/csrc`` with
nvcc (sm_90a) and holds each against its plain PyTorch version on the card,
at the shapes of the serve and training paths: the fcomb-CRPS forward (A)
and backward (A′), the afCRPS-terms forward (B) and backward (B′), the
GroupNorm chain's forward (C) and backward (C′), the hash dropout (D),
the int8 convolution of the int8 serving path (E) and the quantization
and dequantization of the int8 saved convolution inputs (F, F′) and the
ingest's window mean in XLA's order of additions (G, on the route its
per-shape plan picks; no TPU kernel computes E, F, F′ or G: the JAX
package leaves them to XLA), with each kernel's time
beside its plain version's and its bound; A and
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
  channels_last;
- int8 serving (``int8``): kernel E's two routes (``int8_conv.plan``:
  the s8 ``wgmma`` kernel, and the first design, ``mma.sync``, for inputs
  TMA cannot address) bit for bit against the plain version at shapes
  beyond the flagship's (E_CASES) and at 128x128x32 -> 32 on both routes,
  the first design's time beside the new one's; the f32 int8 prior
  ensemble (bs=2) on the card against the CPU, then, on the bf16
  flagship, ``calibrate_sample`` on 4 batches of other synthetic days (99
  scales, 97 with the latent heads kept in float), kernel E bit for bit
  against its plain version (int32 sums and outputs) at every hooked
  convolution of a sample call at bs=128 bf16 and bs=16 f32, on the
  call's own activations, with E's route and plan, its time, its plain
  version's, its bound and two yardsticks the port never calls (cuDNN's
  bf16 convolution, ``torch._int_mm`` over ``F.unfold``), and their sums
  over the call; the prior ensemble (M=16) float against int8
  (member-fields/s, 87 E launches a call, 2 of them on the first design,
  and 57 C, 85 E with the heads in float, E's share of the call's device
  time) and the eval ELBO (M=5) calibrated by ``calibrate_elbo``, float
  against int8 (101 E a step, 3 on the first design);
- the serve CLI, through ``cli.main`` as ``python -m probunet_tpu_torch``
  runs it: ``pack`` of the flagship's test split (4,380 synthetic days),
  a checkpoint of a seeded flagship model, ``evaluate`` over the packed
  split at the defaults (f32, M=16, bs=16) and at bf16, bs=128, with the
  histogram pass, and ``extremes`` (M=8, bs=32, two pixels, 30 bootstrap
  draws): days served, metrics, phase times, days/s, peak host memory,
  57 C launches per U-Net forward; under ``--quant int8 --quant-skip
  heads``, ``evaluate`` at bf16 bs=128, ``extremes``, and ``infer-domain
  --preset fulldomain_dp8`` (the 280x280 domain in 9 tiles a day, 4 days,
  32 members, 16 tiles a chunk) in float and int8 (85 E launches a U-Net
  forward served int8); then ``evaluate`` and ``extremes`` on 32 days and
  ``infer-domain`` on a 140x140 domain (float and int8) on the card
  against the CPU (``PROBUNET_PLATFORM=cpu``);
- the training CLI, through ``cli.main``: ``pack`` of the flagship's
  train split cut to 1960-1962 and its validation split cut to 2021;
  ``train`` at the preset (f32, bs=32, M=15, 2 epochs), at bf16 bs=128
  and with the WMSE + MS-SSIM ELBO (A, A′, C and C′ launched; the
  residual-contribution and final lines printed); ``deterministic_64`` at
  its full widths: ``train`` with the L1 ELBO and ``train-det`` for each
  U-Net type (C and C′; D on the asymmetric ones; the chains by route,
  D, C and C′ held to their plain versions at each chain's shape and dtype),
  ``linearcnn`` and ``bcsd`` (its test MAE on the card against the CPU);
  one epoch of prefetched batches bit-equal to synchronous copies, the
  host's work per batch and three warmed-up epochs' idle share (kernel
  and wall time from the same profiled epochs). Before the phase the
  new ELBO branches (WMSE + MS-SSIM, L1) and the deterministic step run
  in f32 on the card against the CPU;
- EDM (``edm``): ``EDMPrecond`` at the reference baseline's widths
  (64 channels, mult 1,2,3,4, two blocks, dropout 0.1, the noise
  embedding; 28 blocks, 57 GroupNorm chains a pass, all on C), f32, on
  the flagship's data conditioned on the standardized lrinterp: one
  ``edm_loss`` with its gradients and one AdamW step on the card against
  the CPU (TF32 off); ``make_edm_train_step`` at bs=32 (samples/s, peak
  memory, 57 C and 57 C′ launches a step, the step's device time by
  kernel family); ``edm_sample`` (18 steps, 35 denoiser calls, 1,995 C
  launches) over 8 days and ``edm_ensemble`` with 16 members
  (member-fields/s, finite HR fields); C and C′ against their plain
  versions at every chain shape of a bs=32 pass, per-sample FiLM, on
  each route of their plans;
- ``explore`` through ``cli.main`` on the flagship checkpoint the training
  CLI's preset run wrote, over the serve CLI's packed test split: the
  default command, ``--posterior`` and ``--single`` (seconds, files, the
  ``[timing]`` phases, 57 C launches a U-Net forward), then
  ``collapse_diagnostics`` on the card against the CPU, probe by probe;
  then the f32 int8 sample path on that trained checkpoint, card against
  CPU within SERVE_SHARE of the CPU's int8-vs-float gap, with the first
  convolution whose int8 input differs between them;
- the benchmark (``bench``), through ``cli.main(["bench"])`` as ``python
  -m probunet_tpu_torch bench`` runs it: ``train``, ``eval``, ``msssim``,
  ``ensemble``, then ``ensemble`` and ``eval`` under ``BENCH_QUANT=int8``,
  at the flagship's defaults (bs=128, bf16), each line printed whole with
  its rate, FLOP count (the plain route's, on the CPU), MFU share (at
  most MFU_LIMIT), peak memory and the card's power limit, and the
  kernels of its path launched (E on the int8 modes);
- int8 saved convolution inputs (``act_compress``, the JAX package's
  ``PROBUNET_ACT_COMPRESS=int8``): kernels F (per-channel absmax, then
  scales and int8 values) and F′ (dequantization) bit for bit against
  their plain versions at the flagship's 128x128x32 bf16 convolution input
  (bs=128) and one f32 shape, and on their one-element-a-thread instances
  (the first convolution's 3-channel input, bf16 and f32, and views one
  element past alignment), ties and a zero channel included, timed beside
  them with their bounds; the f32 compressed training step on the
  card against the CPU; the bf16 flagship's compressed eval step (no F,
  no F′) and train step (one F and one F′ per convolution input) and the
  bytes the step saves for the backward with compression off and on;
  ``bench`` train with ``PROBUNET_ACT_COMPRESS`` unset and ``int8`` at
  bs=128 and 512 (samples/s, peak memory);
- the parallel paths (``parallel``): in a world of one over NCCL,
  ``make_parallel_train_step`` at the flagship's training step (bf16,
  bs=128, M=15) bit-equal to ``make_train_step``'s from the same state
  and seed (A, A′, C and C′ launched), both steps' samples/s, and an
  all-reduce of the gradients' size over the world timed against the
  step; then two gloo ranks sharing this card
  (NCCL will not put two ranks on one GPU) in one two-process launch,
  f32 at full widths, dropout 0.1, a global batch of 8: two
  data-parallel steps on both GroupNorm routes against two one-process
  steps, with a planted fault (rank 1's kernel C masks not shifted to its
  rows) that the parameter check must catch, C, C′ and D on a rank's
  slab told its offset bit for bit against
  the whole batch's rows, ``make_parallel_sample_step`` (member = 2,
  float and int8) against one rank's sample path, ``infer-domain --dp 2``
  on a 140x140 domain against the one-process command, ``halo_conv2d``
  and the tensor-parallel pair against their unsharded counterparts;
  then the spatially sharded paths (the ``spatial`` lines) on a 1 x 2
  ("data", "spatial") mesh, each rank 64 of the 128 rows: two train steps
  on the kernel route (split C/C′, A/A′) and two on the composed route
  (D with its block mapping, B/B′) against two one-process steps, with a
  planted fault (rank 1's C seed words without the row offset) that must
  be caught; the eval step; ``make_parallel_sample_step`` on a 1 x 2 x 1
  ("data", "spatial", "member") mesh, float and int8 (E on the
  halo-padded blocks); then the spatial step's later options (the
  ``spatial mse+ssim``, ``spatial l1``, ``spatial eval step bilinear`` and
  ``spatial sample bilinear`` lines): two WMSE + MS-SSIM steps on the
  kernel route and one L1 step on the composed route on the 1 x 2 mesh,
  the eval and sample steps under bilinear interpolation, and two WMSE +
  MS-SSIM steps on a 2 x 1 data-parallel mesh, whose MS-SSIM data range is
  the global batch's, with a planted fault (each slab's own range) that
  must fail the agreement. Before the ranks, in this process, split C and C′
  at every chain of the flagship at half height against their split
  plain versions (masks bit for bit) and at the first chain at bs=128
  also timed beside the unsplit route on the same block; D with the
  block mapping bit for bit and timed; E on halo-padded blocks bit for
  bit against the whole image's convolution.

Each path's launch counters are set to 0 just before it and read just
after: every kernel of the path must have launched. Needs a CUDA device and
nvcc; there is no CPU route. Any failed check raises, so the exit code is
0 only when every phase passed. The line before the last is a JSON object
with each kernel's launches on its main path (``launches``: the training
path for A to D, the int8 serve runs for E's two routes, ``int8_conv``
and ``int8_conv_mma_sync``, ``bench`` train under compression at bs=128
for F and F′), on the int8 serve runs
(``launches_int8``), on the serve CLI's runs (``launches_cli``), on the training CLI's runs
(``launches_train_cli``), on the EDM runs (``launches_edm``), on the
``explore`` runs (``launches_explore``), on the bench runs (``launches_bench``), on
the act_compress runs (``launches_act_compress``), on the parallel runs
(``launches_parallel``: the world of one and both gloo ranks) and on the spatially sharded runs (``launches_spatial``, both
ranks; C's and C′'s split route ``launches_spatial_split``) and on the
spatial options' runs (``launches_spatial_options``,
``launches_spatial_options_split``), error, times
and bound, and C's, C′'s and D's times at the spatial block (``split_*``,
``mapped_*``); the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import importlib.util
import io
import json
import math
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from probunet_tpu_torch import cli
from probunet_tpu_torch.analysis.latent import collapse_diagnostics, format_summary
from probunet_tpu_torch.config import preset
from probunet_tpu_torch.data.climex import (
    ClimexDataset,
    compute_stats,
    load_packed,
    lrinterp_from_batch,
    preprocess_batch,
    residual_to_hr,
)
from probunet_tpu_torch.data.loader import Batches, prefetch_to_device
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.data.transforms import apply_physical_transform, invert_physical_transform
from probunet_tpu_torch.evals.streaming import EvalAccumulator
from probunet_tpu_torch.models.edm import EDMPrecond
from probunet_tpu_torch.models.layers import EDMGroupNorm
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.models.unet import UNet, dropout_seeds
from probunet_tpu_torch.ops import act_compress, losses, quantize
from probunet_tpu_torch.ops.kernels import _build, afcrps, dropout, fcomb_crps, fused_gn
from probunet_tpu_torch.ops.kernels import avg_pool as avg_pool_g
from probunet_tpu_torch.ops.kernels import int8_conv as int8_e
from probunet_tpu_torch.train import loop as train_loop
from probunet_tpu_torch.train.checkpoint import CheckpointManager
from probunet_tpu_torch.train.edm import edm_ensemble, edm_loss, edm_sample, make_edm_train_step
from probunet_tpu_torch.train.loop import (
    Trainer,
    eval_model,
    make_deterministic_train_step,
    make_eval_step,
    make_train_step,
    train_epoch,
)
from probunet_tpu_torch.train.state import TrainState, create_train_state, global_norm
from probunet_tpu_torch.utils.saved_bytes import elbo_saved_bytes

BATCH = 128          # bench.py's serve batch
N_BATCHES = 3
ENSEMBLE_M = 16      # bench.py's prior-ensemble size
# kernel vs plain version on the card, f32 and bf16: the same rounding
# points, sums in another order (per-thread then fixed-order block sums vs
# ATen's reductions); 2.3e-7 reached on an H100
KERNEL_RTOL = 1e-5
# kernel B vs its plain version above 32 members in bf16: the plain form
# takes the sorted identity in f32, while the kernel rounds each |x_j - x_k|
# to bf16 (as the TPU kernel does), within 2^-9 of itself. Every term is
# nonnegative, so the sums differ by at most 2^-9 of the total. The kernel
# is also held to the pairwise form, which rounds as it does, at KERNEL_RTOL
SORTED_BF16_RTOL = 2.0 ** -9
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
# differ by more than 1e-4 of the largest value (6.77e-6 reached at K = 3;
# 2.7e-6, 5.5e-6 and 6.2e-6 at K = 1, 2 and 4, bs=128, on an H100).
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
# the serve CLI phase: the flagship's test split (2034-2046, 12 synthetic
# years of 365 days), served from its packed artifact; extremes at its
# defaults but for two pixels and 30 bootstrap draws (the fits run on one
# host process: 100 draws took 43.6 s on the card's host, 1,000 take ~10x
# that); the card-vs-CPU check on 32 days at bs=16, with one day a "year"
# so that extremes.json's annual maxima are the pixel series itself
CLI_PRESET = "probunet_multivar_128"
CLI_TEST_DAYS = 4380
CLI_EXTREMES = ["--pixels", "20,45", "64,64", "--n-boot", "30"]
CLI_CHECK_EVAL = ["--max-items", "32", "--batch-size", "16"]
CLI_VARIABLES = ("pr", "tasmin", "tasmax")
# the int8 serve CLI runs: the flags, a two-year validation split to
# calibrate on (4 batches of 128 days), extremes with fewer bootstrap draws than the float run, and
# infer-domain's synthetic domain generated for one test year (4 days served)
INT8_FLAGS = ["--quant", "int8", "--quant-skip", "heads"]
INT8_VAL_YEARS = [2021, 2023]
INT8_EXTREMES = ["--pixels", "20,45", "64,64", "--n-boot", "20"]
INFER_DOMAIN_YEARS = [2034, 2035]
CLI_CHECK_EXTREMES = ["--pixels", "20,45", "64,64", "--days", "32", "--batch-size", "16",
                      "--days-per-year", "1", "--n-boot", "10"]
# the training CLI phase: the flagship's train split cut to 3 years and its
# validation split to 1 (packed), trained at the preset (f32, bs=32, M=15,
# 2 epochs), at bf16 bs=128 and with the WMSE + MS-SSIM ELBO; the
# deterministic baselines at deterministic_64's full widths (64x64, model
# channels 64, mult 1,2,3,4, bs=8) on 2 packed training years, 1 synthetic
# validation and test year (BCSD needs whole years), one epoch each; the asymmetric
# U-Nets take the low-resolution field (pipeline lr_to_residuals), their
# core at 8x8 -> 1x1
TRAIN_CLI_YEARS = {"train": [1960, 1963], "val": [2021, 2022]}
TRAIN_CLI_RUNS = (("f32 bs=32 M=15 (preset)", ["train.num_epochs=2"]),
                  ("bf16 bs=128", ["model.compute_dtype=bfloat16", "train.batch_size=128",
                                   "train.num_epochs=1"]),
                  ("mse+ssim f32 bs=32", ["loss.loss_type=mse+ssim", "train.num_epochs=1"]))
DET_PRESET = "deterministic_64"
DET_YEARS = {"train": [1960, 1962], "val": [2021, 2022], "test": [2034, 2035]}
DET_VARIANTS = (("unet symmetric", ["model.unet_type=symmetric", "train.num_epochs=1"]),
                ("unet asymmetric_wskips", ["model.unet_type=asymmetric_wskips",
                                            "data.pipeline=lr_to_residuals",
                                            "train.num_epochs=1"]),
                ("unet asymmetric_woskips", ["model.unet_type=asymmetric_woskips",
                                             "data.pipeline=lr_to_residuals",
                                             "train.num_epochs=1"]),
                ("linearcnn", ["train.num_epochs=1"]))
# BCSD's test MAE on the card vs the CPU: the storage transform and the
# interpolation differ by an ulp or so between the devices, and BCSD divides
# by the training years' interpolated precipitation, near 0 at dry pixels,
# which multiplies those ulps (5.7e-5 between the port and the JAX package
# on the CPU test split)
BCSD_RTOL = 1e-3
# warmed-up bf16 bs=128 epochs of 8 steps each, profiled together for the
# idle share (24 steps), then timed together without the profiler
IDLE_EPOCHS = 3
PREFETCH_BUSY_N = 4096   # the consumer's work between prefetched batches: 4 products of n x n
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
# dense bf16 tensor core; FP32 CUDA core; dense int8 tensor core
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# int8 serving (kernel E, the `int8` phase): the flagship sample path's
# scales tree (87 in_scale leaves, 12 of them with an in_scale2: 73 U-Net
# EDMConvs, 12 split, and 14 prior _Conv3x3s), one E launch a convolution
INT8_SAMPLE_LEAVES, INT8_SAMPLE_SPLIT, INT8_HEADS = 99, 12, 2
# of those, E's first design (route "mma_sync") takes the cin = 3 first
# convolutions (the U-Net's and the prior's) a sample call, and the
# posterior's cin = 6 one besides an eval step
E_MMA_SYNC_SAMPLE, E_MMA_SYNC_EVAL = 2, 3
INT8_CALIB_BATCHES = 4
# int8 `infer-domain` on the card against the CPU: the metrics' difference
# over the CPU's int8-vs-float gap (the CPU tests' serving bound,
# tests/test_torch_quantize.py)
SERVE_SHARE = 0.1
# the main row of kernel E: the flagship's 128x128x32 -> 32 3x3 convolution;
# the main row of its first design, route "mma_sync": the 128x128x3 -> 32
# first convolutions (the U-Net's and the prior's)
E_MAIN = (3, 32, 0, 32, 128, 128)
E_MMA_SYNC_MAIN = (3, 3, 0, 32, 128, 128)
# kernel E beyond the flagship's shapes, each on its planned route, bit for
# bit against the plain version: (k, cin, cin2, cout, n, h, w, dtype, out
# dtype, ties). Input channels off a multiple of 32 (TMA's zero fill) and 8
# wide (a box wider than the tensor), cout off a block, images smaller than
# a tile and 8 or fewer wide (16 x 8 tiles), a split 3x3, three channel
# blocks of a split 1x1, f32 at 256 channels (two stages), f32 out of
# bf16, f32 on the first design, and quotients at exact ties (inputs on a
# grid of half-integer multiples of a power-of-two scale)
E_CASES = ((3, 40, 0, 24, 3, 13, 21, "bfloat16", "bfloat16", True),
           (3, 8, 0, 8, 2, 10, 10, "bfloat16", "float32", False),
           (3, 20, 0, 48, 2, 7, 6, "float32", "bfloat16", True),
           (1, 24, 16, 264, 2, 9, 11, "bfloat16", "float32", False),
           (3, 64, 32, 40, 2, 12, 12, "bfloat16", "bfloat16", False),
           (3, 16, 0, 256, 2, 5, 5, "float32", "float32", False),
           (3, 3, 0, 32, 2, 17, 9, "float32", "float32", False))
# the f32 int8 sample path on trained weights (the training CLI's preset
# checkpoint), card against CPU: days of the packed test split
INT8_TRAINED_DAYS = 2
# the EDM phase: EDMPrecond at the reference baseline's widths (its
# deterministic_unet.py defaults: 64 channels, mult 1,2,3,4, two blocks,
# dropout 0.1, the noise embedding, no labels), f32, on the flagship's data
# (128x128 pr/tasmin/tasmax, residual pipeline) conditioned on the
# standardized lrinterp: 6 input channels, 3 out
EDM_WIDTHS = dict(model_channels=64, channel_mult=(1, 2, 3, 4), num_blocks=2, dropout=0.1,
                  use_diffuse=True, label_dim=0, sigma_data=1.0)
# GroupNorm chains of one pass of the flagship's or EDM's U-Net: 28 blocks
# of two chains each and out_norm
UNET_CHAINS = 57
EDM_TRAIN_BS, EDM_TRAIN_WARMUP, EDM_TRAIN_STEPS = 32, 2, 6
EDM_SAMPLE_DAYS, EDM_MEMBERS, EDM_STEPS = 8, 16, 18
# f32 EDM loss on the card (kernels, TF32 off) vs the CPU (plain versions),
# two items with the same sigma, noise and seed words: a smooth loss (no
# sign flips as in the CRPS), convolution and reduction orders differing
# through 28 blocks forward and back: the loss within DEVICE_RTOL, each
# parameter's gradient ||g - g_cpu|| / ||g_cpu|| within EDM_GRAD_RTOL
EDM_GRAD_RTOL = 1e-3
# collapse_diagnostics on the card vs the CPU (f32, TF32 off, the same
# weights, contexts and draws): each probe max |card - cpu| over the
# largest |cpu| value; the probes are differences and ratios of f32 decodes
# and gradients, which amplify the decodes' ENSEMBLE_RTOL-sized differences;
# the output and target means held to their std. Probe 8 (the gradient
# ratio) goes through Fcomb's ReLUs, whose masks flip where a hidden value
# lies within the two devices' f32 differences: GRAD_RTOL, as the CRPS
# step's gradients (3.9e-4 reached on an H100, the other probes 1.4e-6)
# `python -m probunet_tpu_torch bench`, once per mode (its env knobs): each
# must launch the kernels of its path (A, A′ on the afCRPS steps, C, C′ on
# the training steps, C everywhere, E on the int8 modes) and read an MFU
# share no higher than MFU_LIMIT (above 1 the FLOP count or the clock is
# wrong; 0.05 for the rounding of a share near 1)
BENCH_MODES = (("train", {}, ("fcomb_crps", "fcomb_crps_bwd", "fused_gn", "fused_gn_bwd")),
               ("eval", {}, ("fcomb_crps", "fused_gn")),
               ("msssim", {}, ("fused_gn", "fused_gn_bwd")),
               ("ensemble", {}, ("fused_gn",)),
               ("ensemble", {"BENCH_QUANT": "int8"}, ("fused_gn", "int8_conv")),
               ("eval", {"BENCH_QUANT": "int8"}, ("fcomb_crps", "fused_gn", "int8_conv")))
BENCH_ENV = ("BENCH_MODE", "BENCH_QUANT", "BENCH_QUANT_SKIP", "BENCH_BS", "BENCH_DTYPE",
             "BENCH_REMAT", "BENCH_DROPOUT", "PROBUNET_ACT_COMPRESS")
BENCH_TRAIN_KERNELS = BENCH_MODES[0][2]
# int8 saved convolution inputs (the `act_compress` phase, kernels F and
# F′): the NHWC shapes held bit for bit against the plain versions, each
# with the kernel instance it must take (8 elements a thread, or 1 where C
# % 8 != 0 or a pointer is misaligned): the flagship's dominant bf16
# convolution input at bs=128 (whose times go into the kernels line), one
# f32 input, the first convolution's 3-channel input in bf16 (the main
# path) and in f32 (the f32 step), and the dominant input again through
# views one element past alignment; then the bench batch sizes run with
# compression off and on, and the batch of the card's compressed eval and
# train steps whose launches are counted
ACT8_CASES = (((BATCH, 128, 128, 32), "bfloat16", False), ((32, 64, 64, 64), "float32", False),
              ((BATCH, 128, 128, 3), "bfloat16", False), ((8, 128, 128, 3), "float32", False),
              ((BATCH, 128, 128, 32), "bfloat16", True))
ACT8_BENCH_BS = (128, 512)
ACT8_STEP_BS = 16
ACT8_KERNELS = ("act_compress_quantize", "act_compress_dequantize")
MFU_LIMIT = 1.05
EXPLORE_RTOL = 1e-3
EXPLORE_CHECK = dict(max_items=64, n_contexts=8)
# the parallel phase (parallel_phase): two gloo ranks share cuda:0 (NCCL
# will not put two ranks on one GPU), f32, TF32 off, full widths, dropout
# 0.1, a global batch of 8 (4 a rank); the world of one runs over NCCL
PAR_BATCH, PAR_SAMPLE_M = 8, 16
# kernel G (the ingest's window mean) against its plain version bit for bit,
# twice: (shape, k, first row of a block of rows or None, timed). The main
# path's pooling (bs=128, 128x128, 3 variables, k = 16); the spatial phase's
# block (rows 64-127 of a PAR_BATCH batch, as shard_batch gives it); an odd
# k (the generic instance, on "channels": a window row of 9 floats is no
# whole 16-byte copy); the 64x64 presets' batch pooled by 8; a year's
# stack for compute_stats (72 MB, more than the L2 cache holds); a wide C
# that takes the "channels" route.
G_CASES = (((BATCH, 128, 128, 3), 16, None, True),
           ((PAR_BATCH, 128, 128, 3), 16, 64, False),
           ((PAR_BATCH, 96, 96, 3), 3, None, False),
           ((BATCH, 64, 64, 1), 8, None, False),
           ((365, 128, 128, 3), 16, None, True),
           ((8, 32, 32, 64), 16, None, False))
# G's time at the main pooling before its redesign (PERF.md, kernel G;
# NVIDIA H100 80GB HBM3, 700.00 W)
G_BEFORE_MS = 0.01927
# the main pooling through a view one element past 16 bytes: the plan takes
# "channels" (the ring's 16-byte copies cannot), timed
G_OFF16 = ((BATCH, 128, 128, 3), 16)
PAR_STEPS, PAR_WARMUP = 4, 2
PAR_TIMEOUT = 420
# two data-parallel steps against two one-process steps on the card: at
# each step the metrics within PAR_RTOL, and the gradients AdamW receives
# (the all-reduced mean against the whole batch's: the largest difference
# over the largest gradient) within PAR_RTOL at the first step (the ranks'
# half-batch convolutions may take other cuDNN algorithms than one
# batch's) and PAR_RTOL_STEP2 at the second, which the two runs reach
# from states Adam's signs have already set apart (an H100 run: 0.56% of
# the elements 2 lr apart, the second gradients 1.27e-4 apart, the first
# 4.6e-7). The parameters after the two
# steps: Adam's first update is lr * g / (|g| + 1e-8), about +-lr wherever
# |g| > 1e-8, so an element whose gradient lies at the level of rounding
# may move the other way; its second update depends on both gradients'
# sizes. So (1) every element whose gradient is, at both steps, above
# PAR_CLEAR times the largest gradient difference of that step may differ
# by at most PAR_PARAM_LR lr, and (2) at most PAR_MOVED_SHARE of all
# elements may differ by more than 0.1 lr. A planted fault (rank 1's C
# masks those of rows 0:4: ``fused_gn.slab_seed`` not applied) must
# exceed PAR_MOVED_SHARE, so the share check is shown to fail on a wrong
# step in every run (an H100 run: 0.565% of the elements on either route,
# the planted fault 56.8%; the fault's first gradients read 6.1e-7 of the
# largest apart and its grad_norm equal, so only the share and recon
# caught it).
PAR_RTOL = 1e-4
PAR_RTOL_STEP2 = 1e-3
# the spatially sharded int8 sample against the one-process one
# (_int8_agreement): the mean difference at most this share of the mean
# int8-vs-float gap, and the two ensembles' mean distances from the float
# ensemble within this share of each other. A rounding tie that the
# blocks' GroupNorm sums move (one element of 32,768, x/s = k + 0.5000038,
# in the CPU test's 8-channel model) steps every later value of the image:
# 0.15 and 0.0004 there, 0.26 and 0.0075 on a 32/16-channel model of the
# synthetic fields. A wrong halo or crop moves the ensemble by about the
# gap itself.
SPATIAL_INT8_MEAN_SHARE = 0.5
SPATIAL_INT8_GAP_SHARE = 0.05
PAR_CLEAR = 1e3
PAR_PARAM_LR = 0.01
PAR_MOVED_SHARE = 0.02


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
# kernels each, B's and B′'s member buckets and slab kernels, C's and C′'s
# two routes each, D with and without its block mapping)
PTXAS_KERNELS = ("fcomb_crps_fwd_mma_kernel", "fcomb_crps_tile_kernel",
                 "fcomb_crps_bwd_mma_kernel", "fcomb_crps_bwd_tile_kernel",
                 "afcrps_tile_kernel", "afcrps_tile_smem_kernel", "afcrps_reduce_kernel",
                 "afcrps_bwd_kernel", "afcrps_bwd_smem_kernel",
                 "gn_fwd_cluster_kernel", "gn_fwd_stats_kernel", "gn_fwd_apply_kernel",
                 "gn_bwd_cluster_kernel", "gn_bwd_reduce_kernel", "gn_bwd_dx_kernel",
                 "dropout_kernel", "int8_conv_kernel", "int8_conv_wgmma_kernel",
                 "act8_absmax_kernel", "act8_quantize_kernel", "act8_dequantize_kernel",
                 "window_mean_ring_kernel", "window_mean_direct_kernel",
                 "window_mean_channels_kernel")


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


def _fcomb_vs_plain(randn, b: int, c: int, p: int, k: int, m: int, dtype: str) -> dict:
    """Kernels A and A′ against their plain versions at one shape, each run
    twice for identical bits; prints both and returns their JSON rows."""
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
        raise AssertionError(f"fcomb_crps kernel disagrees with its plain version at K={k}: "
                             f"rel err {rel_err} > {KERNEL_RTOL}")
    ops = 2.0 * b * p * m * (c * c + c * k)
    rows = {"fcomb_crps": {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                           **_bound(4.0 * b * p * (c + k), ops, dtype), "library_ms": None}}
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
    plain_ms = _sync_ms(lambda: fcomb_crps.fcomb_crps_terms_bwd_plain(*args, g1, g2, dtype),
                        1, 1)
    print(f"kernel fcomb_crps_bwd  B={b} C={c} P={p} K={k} M={m:2d} {dtype:8s} "
          f"bit_reproducible=True max_err/max={json.dumps(errs)} "
          f"tie_fraction={json.dumps(ties)} max_abs_err={abs_err:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    bad = {n: e for n, e in errs.items() if n not in ("dfeat", "dy") and not e <= BWD_RTOL[dtype]}
    bad.update({n: f for n, f in ties.items() if not f <= TIE_FRACTION})
    if bad:
        raise AssertionError(f"fcomb_crps backward disagrees with its plain version at K={k}: "
                             f"{bad}")
    # the algorithm's products: decode (C^2 + CK), dh1, dW2 (CK each), dh0,
    # dW1 (C^2 each); read feat, y; write dfeat, dy
    ops = 2.0 * b * p * m * (3 * c * c + 3 * c * k)
    rows["fcomb_crps_bwd"] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                              **_bound(8.0 * b * p * (c + k), ops, dtype), "library_ms": None}
    return rows


def _afcrps_inputs(randn, b: int, m: int, p: int, dtype: str, member_major: bool):
    """ens (B, M, P), contiguous or the member-major view Fcomb.ensemble
    gives (transpose(0, 1) of an (M, B, P) tensor), with ties among the
    members and against the target; tgt (B, P); g1, g2 (B,)."""
    tdt = getattr(torch, dtype)
    ens = (randn(m, b, p).to(tdt).transpose(0, 1) if member_major
           else randn(b, m, p).to(tdt))
    tgt = randn(b, p).to(tdt)
    n = min(64, p)
    if m > 1:
        ens[:, 1, :n] = ens[:, 0, :n]   # sign 0 between members
    tgt[:, : n // 2] = ens[:, -1, : n // 2]  # and against the target
    return ens, tgt, randn(b, scale=1e-3), randn(b, scale=1e-3)


def _afcrps_check(ens, tgt, g1, g2) -> dict:
    """Kernels B and B′ against their plain versions on one input: B twice
    for identical bits, within KERNEL_RTOL of the plain terms (t2 above 32
    members: within SORTED_BF16_RTOL of the sorted plain form in bf16, and
    within KERNEL_RTOL of the pairwise form, which rounds each difference as
    the kernel does); B′ equal to the plain backward, dx in ens's layout.
    Returns the errors."""
    m = ens.shape[1]
    got = afcrps.ensemble_crps_terms_fwd(ens, tgt)
    again = afcrps.ensemble_crps_terms_fwd(ens, tgt)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"afcrps forward is not bit-reproducible at {tuple(ens.shape)}")
    want = afcrps.ensemble_crps_terms_plain(ens, tgt)
    abs_err, rel_err = _errors(got, want)
    out = {"max_abs_err": abs_err, "max_rel_err": rel_err}
    limit = KERNEL_RTOL
    if m > losses._PAIRWISE_MAX_M:
        out["t2_rel_err_pairwise"] = _errors(got[1:], (losses._pairwise_abs_sum(ens),))[1]
        out["t1_rel_err"] = _errors(got[:1], want[:1])[1]
        if ens.dtype == torch.bfloat16:
            limit = SORTED_BF16_RTOL
        if not max(out["t2_rel_err_pairwise"], out["t1_rel_err"]) <= KERNEL_RTOL:
            raise AssertionError(f"afcrps kernel disagrees with the pairwise form at M={m}: "
                                 f"{out}")
    if not rel_err <= limit:
        raise AssertionError(f"afcrps kernel disagrees with its plain version at "
                             f"{tuple(ens.shape)} {ens.dtype}: rel err {rel_err} > {limit}")
    got = afcrps.ensemble_crps_terms_bwd(ens, tgt, g1, g2)
    want = afcrps.ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2)
    out["exact"] = all(torch.equal(x, y) for x, y in zip(got, want))
    out["bwd_max_abs_err"] = max(float((x.float() - y.float()).abs().max())
                                 for x, y in zip(got, want))
    out["dx_strides"] = list(got[0].stride())
    # sign counts times g, with the same two roundings: equal exactly
    if not out["exact"]:
        raise AssertionError(f"afcrps backward differs from its plain version at "
                             f"{tuple(ens.shape)} {ens.dtype}: {out['bwd_max_abs_err']}")
    if got[0].stride() != ens.stride():
        raise AssertionError(f"afcrps backward wrote dx at strides {got[0].stride()}, "
                             f"ens has {ens.stride()}")
    return out


def _afcrps_vs_plain(randn) -> dict:
    """Kernels B and B′ at the unfused training route's shape (B=128,
    P=128*128*3), M=15 and 5, f32 and bf16: checked, and timed on the
    contiguous ensemble (the JSON row: M=15, f32) and on the member-major
    view the route hands them."""
    report = {}
    b, p = BATCH, 128 * 128 * 3
    for m in (TRAIN_M, 5):
        for dtype in ("float32", "bfloat16"):
            ms, plain_ms, errs = {}, {}, {}
            for layout in ("contiguous", "member_major"):
                ens, tgt, g1, g2 = _afcrps_inputs(randn, b, m, p, dtype, layout == "member_major")
                errs[layout] = _afcrps_check(ens, tgt, g1, g2)
                ms[layout] = (_sync_ms(lambda: afcrps.ensemble_crps_terms_fwd(ens, tgt), 20),
                              _sync_ms(lambda: afcrps.ensemble_crps_terms_bwd(ens, tgt, g1, g2),
                                       20))
                if layout == "contiguous":
                    plain_ms = (
                        _sync_ms(lambda: afcrps.ensemble_crps_terms_plain(ens, tgt), 3, 1),
                        _sync_ms(lambda: afcrps.ensemble_crps_terms_bwd_plain(ens, tgt, g1, g2),
                                 3, 1))
                del ens, tgt
            c, mm = ms["contiguous"], ms["member_major"]
            e = errs["contiguous"]
            print(f"kernel afcrps          B={b} P={p} M={m:2d} {dtype:8s} "
                  f"bit_reproducible=True max_rel_err={e['max_rel_err']:.3e} "
                  f"max_abs_err={e['max_abs_err']:.3e} kernel_ms={c[0]:.4f} "
                  f"member_major_ms={mm[0]:.4f} plain_ms={plain_ms[0]:.4f}")
            print(f"kernel afcrps_bwd      B={b} P={p} M={m:2d} {dtype:8s} exact=True "
                  f"max_abs_err={e['bwd_max_abs_err']:.3e} kernel_ms={c[1]:.4f} "
                  f"member_major_ms={mm[1]:.4f} plain_ms={plain_ms[1]:.4f}")
            if (m, dtype) == (TRAIN_M, "float32"):
                size = 4
                pair_ops = 3.0 * b * p * (m + m * (m - 1) / 2)  # sub, abs, add per term
                sign_ops = 3.0 * b * p * (m * m + m)  # sub, sign, add per term
                report["afcrps"] = {"max_abs_err": e["max_abs_err"], "ms": c[0],
                                    "plain_ms": plain_ms[0],
                                    **_bound(size * b * p * (m + 1), pair_ops, "float32"),
                                    "library_ms": None}
                report["afcrps_bwd"] = {"max_abs_err": e["bwd_max_abs_err"], "ms": c[1],
                                        "plain_ms": plain_ms[1],
                                        **_bound(2.0 * size * b * p * (m + 1), sign_ops,
                                                 "float32"),
                                        "library_ms": None}
    return report


def afcrps_cases(randn) -> None:
    """Kernels B and B′ at every member bucket and both sides of it (M = 2,
    5, 15, 16, 32 in registers; 33, 64 on the shared-memory slab; 128 with
    the slab above 48 KB; 500 read from device memory), f32 and bf16,
    contiguous and member-major, at an aligned P and a ragged one (one load
    a pixel); and a batch above the grid's old 65535 limit."""
    cases = [(8, m, p) for m in (2, 5, 15, 16, 32, 33, 64) for p in (49152, 49157)]
    cases += [(2, 128, 4099), (2, 500, 4099), (66000, 5, 12)]
    for b, m, p in cases:
        for dtype in ("float32", "bfloat16"):
            for member_major in (False, True):
                ens, tgt, g1, g2 = _afcrps_inputs(randn, b, m, p, dtype, member_major)
                out = _afcrps_check(ens, tgt, g1, g2)
                print(f"afcrps case B={b} M={m} P={p} {dtype} "
                      f"{'member_major' if member_major else 'contiguous'}: {json.dumps(out)}")
                del ens, tgt


def _dropout_vs_plain(randn, shape, dtype: str, p_drop: float, timed: bool = True):
    """Kernel D against its plain version at one NHWC shape: forward (on x)
    and backward (on a cotangent) bit for bit, the keep rate within 5
    sigma of 1 - p. With ``timed``, the JSON row: its time beside the
    plain version's, ``F.dropout``'s and its bound."""
    tdt = getattr(torch, dtype)
    x = randn(*shape).to(tdt).requires_grad_()
    g = randn(*shape).to(tdt)
    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=x.device)
    y = dropout.dropout(x, seed, p_drop)
    (dx,) = torch.autograd.grad(y, x, g)
    with torch.no_grad():
        want_y = dropout.dropout_plain(x, seed, p_drop)
        want_dx = dropout.dropout_plain(g, seed, p_drop)
    fwd_exact, bwd_exact = torch.equal(y, want_y), torch.equal(dx, want_dx)
    n = y.numel()
    keep = float((y != 0).float().mean())
    sigma = (p_drop * (1 - p_drop) / n) ** 0.5
    line = (f"kernel dropout         shape={shape} {dtype} p={p_drop} fwd_exact={fwd_exact} "
            f"bwd_exact={bwd_exact} keep_rate={keep:.6f} (1-p={1 - p_drop}, "
            f"{abs(keep - (1 - p_drop)) / sigma:.2f} sigma)")
    row = None
    if timed:
        with torch.no_grad():
            xd = x.detach()
            ms = _sync_ms(lambda: dropout.dropout(xd, seed, p_drop), 20)
            plain_ms = _sync_ms(lambda: dropout.dropout_plain(xd, seed, p_drop), 3, 1)
            library_ms = _sync_ms(lambda: F.dropout(xd, p_drop, training=True), 20)
        line += f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} F.dropout_ms={library_ms:.4f}"
        # read x, write y; ~16 integer operations per element for the hash
        row = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
               **_bound(2.0 * x.element_size() * n, 16.0 * n, "float32"),
               "library_ms": library_ms}
    print(line)
    if not (fwd_exact and bwd_exact):
        raise AssertionError(f"dropout kernel masks differ from the plain version's at "
                             f"{shape} {dtype}")
    if not abs(keep - (1 - p_drop)) <= 5 * sigma:
        raise AssertionError(f"dropout keep rate {keep} at {shape} is not within 5 sigma of "
                             f"{1 - p_drop}")
    return row


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _g_field(gen, dev, shape, h0=None) -> torch.Tensor:
    """A field spread over six decades, as kernel G's cases take it; with
    ``h0`` the block of its rows from h0 on, contiguous."""
    x = torch.randn(shape, generator=gen, device=dev) * 10.0 ** torch.randint(
        -3, 3, shape, generator=gen, device=dev)
    return x if h0 is None else x[:, h0:].contiguous()


def _g_plan_text(pl) -> str:
    if pl.route == "ring":
        return (f"route=ring k_inst={pl.k_inst} tile={pl.rows}x{pl.cols} "
                f"strides={pl.col_stride}/{pl.row_stride} stages={pl.stages} "
                f"threads={pl.threads} smem={pl.smem} grid={pl.grid}")
    return f"route={pl.route} k_inst={pl.k_inst} threads={pl.threads} grid={pl.grid}"


def _avg_pool_vs_plain(gen, dev, shape, k: int, h0, timed: bool, card: str,
                       off16: bool = False):
    """Kernel G on its planned route against its plain version at one
    shape, bit for bit, twice: values spread over six decades; ``h0``: G
    pools the block of the batch's rows from h0 on; ``off16``: x is a view
    one element past 16 bytes, and the plan must take "channels". With ``timed``, the
    JSON row: its time beside the plain version's (k^2 adds on the card),
    ``Tensor.mean`` over the window axes (the same function in another
    order), its bound (x read and the means written once; k^2 adds an
    output) and the share of the HBM rate it reached."""
    x = _g_field(gen, dev, shape, h0)
    if off16:
        x = _misaligned(x)
    what = (f"shape={shape} k={k}" + ("" if h0 is None else f" rows {h0}:{shape[1]}")
            + (" x off 16 bytes" if off16 else ""))
    pl = avg_pool_g.plan_of(x, k)
    if off16 and pl.route != "channels":
        raise AssertionError(f"kernel G's plan for x off 16 bytes is {pl}, not channels")
    want = avg_pool_g.window_mean_plain(x, k)
    got = avg_pool_g._launch(x, k)
    exact = torch.equal(got, want) and torch.equal(avg_pool_g._launch(x, k), got)
    line = f"kernel avg_pool        {what} f32 exact={exact} plan: {_g_plan_text(pl)}"
    row = None
    if timed:
        b, h, w, c = x.shape

        def mean():
            return x.reshape(b, h // k, k, w // k, k, c).mean(dim=(2, 4))

        ms = _sync_ms(lambda: avg_pool_g.window_mean(x, k), 20)
        plain_ms = _sync_ms(lambda: avg_pool_g.window_mean_plain(x, k), 3, 1)
        library_ms = _sync_ms(mean, 20)
        mean_bits = int((mean() != want).sum())
        n_bytes = 4.0 * (x.numel() + want.numel())
        row = {"max_abs_err": float((avg_pool_g.window_mean(x, k) - want).abs().max()),
               "ms": ms, "plain_ms": plain_ms,
               **_bound(n_bytes, float(x.numel()), "float32"), "library_ms": library_ms,
               "plan": _g_plan_text(pl)}
        line += (f" kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} Tensor.mean_ms={library_ms:.5f}"
                 f" bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) HBM share "
                 f"{n_bytes / (ms * 1e-3) / H100_BYTES_PER_S:.4f}; Tensor.mean differs in the "
                 f"last bit at {mean_bits} of {want.numel()} means [{card}]")
    print(line)
    if not exact:
        raise AssertionError(f"kernel G differs from its plain version at {what}")
    return row


def avg_pool_launches_per_step(model: ProbabilisticUNet, batch: torch.Tensor, stats, cfg,
                               dev, zero_counts, read_counts, card: str) -> dict:
    """Kernel G's launches in one training step and one eval step (bs=8)
    of the flagship: one each, the batch's pooling in ``preprocess_batch``."""
    state = create_train_state(copy.deepcopy(model), seed=cfg.train.seed, device=dev)
    zero_counts()
    make_train_step(state.model, cfg)(state, batch, stats, 1.0, 1.0)
    n = {"train": read_counts()["avg_pool"]}
    zero_counts()
    make_eval_step(model, cfg)(batch, stats, torch.Generator(device=dev).manual_seed(0))
    n["eval"] = read_counts()["avg_pool"]
    print(f"kernel avg_pool launches per step: {json.dumps(n)} [{card}]")
    if n != {"train": 1, "eval": 1}:
        raise AssertionError(f"kernel G launched {n} times in a step, not once a pooling")
    del state
    torch.cuda.empty_cache()
    return n


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
            rows = _fcomb_vs_plain(randn, b, c, p, k, m, dtype)
            if (m, dtype) == (TRAIN_M, "bfloat16"):
                report.update(rows)
    # the other class counts' kernel instances (K = 1: the single-variable
    # presets), at the batch TIE_FRACTION was set at
    for k in (1, 2, 4):
        for dtype in ("bfloat16", "float32"):
            _fcomb_vs_plain(randn, b, c, p, k, TRAIN_M, dtype)
    torch.cuda.empty_cache()

    report.update(_afcrps_vs_plain(randn))
    afcrps_cases(randn)
    torch.cuda.empty_cache()

    # D at the flagship's largest activation, NHWC bf16
    report["dropout"] = _dropout_vs_plain(randn, (BATCH, 128, 128, 32), "bfloat16", 0.1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    for i, case in enumerate(GN_CASES):
        rows = _gn_vs_plain(randn, dev, *case)
        if i == 0:
            report.update(rows)
        torch.cuda.empty_cache()
    gn_preset_chains(randn, dev, "probunet_latent6_64", batch=8)
    report["int8_conv_mma_sync_at_main"] = e_routes_vs_plain(gen, dev)
    torch.cuda.empty_cache()
    card = _card()
    for i, (shape, k, h0, timed) in enumerate(G_CASES):
        row = _avg_pool_vs_plain(gen, dev, shape, k, h0, timed, card)
        if i == 0:
            report["avg_pool"] = row
            print(f"kernel avg_pool        main pooling: {row['ms']:.5f} ms (the design "
                  f"before {G_BEFORE_MS} ms, PERF.md), Tensor.mean {row['library_ms']:.5f} ms, bound "
                  f"{row['bound_ms']:.5f} ms; within 2x the bound: "
                  f"{row['ms'] <= 2 * row['bound_ms']}, no slower than Tensor.mean: "
                  f"{row['ms'] <= row['library_ms']} [{card}]")
    _avg_pool_vs_plain(gen, dev, *G_OFF16, None, True, card, off16=True)
    torch.cuda.empty_cache()
    return report


def _e_plan_text(key, n: int, dtype: torch.dtype) -> str:
    """Kernel E's plan for a shape, with the blocks an SM holds on the card."""
    k, cin, cin2, cout, h, w = key
    pl = int8_e.plan(k, cin, cin2, cout, h, w, dtype)
    if pl.route != "wgmma":
        return f"route={pl.route}"
    out = (ctypes.c_int * 2)()
    _build.check(_build.library().int8_conv_wgmma_occupancy(
        n, h, w, cout, k, int(dtype == torch.bfloat16), pl.n_tile, int(cin2 > 0), pl.tile_w,
        pl.stages, out), "int8_conv_wgmma_occupancy")
    if out[0] != pl.smem:
        raise AssertionError(f"E plan {pl} against the kernel's {out[0]} bytes")
    return (f"route=wgmma n_tile={pl.n_tile} tile_w={pl.tile_w} stages={pl.stages} "
            f"smem={pl.smem} blocks_per_sm={out[1]} (planned {pl.blocks_per_sm})")


def _e_case(gen, dev, key, n: int, dtype: str, out_dtype: str, ties: bool, route=None):
    """One convolution's inputs, seeded, and E (on its plan's route, or
    ``route``) against the plain version: int32 sums and outputs bit for bit,
    twice the same bits. Returns (args, kw) for timing."""
    k, cin, cin2, cout, h, w = key
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, x2 = rand(n, h, w, cin) * 2, rand(n, h, w, cin2) if cin2 else None
    weight, bias = rand(cout, cin + cin2, k, k) * 0.3, rand(cout)
    if ties:   # x / s on the half-integers: every other quotient an exact tie
        s1 = s2 = torch.tensor(0.125)
        x = (torch.round(x * 40).clamp(-254, 254) / 2 * 0.125)
    else:
        s1 = int8_e.over_qmax(x.to(dt).float().abs().max()).cpu()
        s2 = int8_e.over_qmax(x2.to(dt).float().abs().max()).cpu() * 0.9 if cin2 else None
    nt = int8_e.block_channels(cout, cin2 > 0)
    qws = [int8_e.quantize_weight(weight[:, :cin], nt)]
    kw = dict(out_dtype=getattr(torch, out_dtype))
    if cin2:
        qws.append(int8_e.quantize_weight(weight[:, cin:], nt))
        kw.update(x2=x2.to(dt), qw2=qws[1], in_scale2=s2)
    args = (x.to(dt), qws[0], s1, bias)
    runs = [int8_e._launch(*args, kw.get("x2"), kw.get("qw2"), kw.get("in_scale2"),
                           kw["out_dtype"], True, route=route) for _ in range(2)]
    want, acc_p = int8_e.int8_conv_plain(*args, **kw, return_acc=True)
    for got, acc in runs:
        if not (torch.equal(acc, acc_p) and torch.equal(got, want)):
            raise AssertionError(
                f"kernel E ({route or 'planned route'}) differs from its plain version at "
                f"{key} n={n} {dtype}->{out_dtype}: max |acc diff| "
                f"{int((acc.long() - acc_p.long()).abs().max())}, max |y diff| "
                f"{float((got.float() - want.float()).abs().max())}")
    return args, kw


def e_routes_vs_plain(gen, dev) -> dict:
    """Kernel E's two routes against the plain version, bit for bit: at
    E_CASES on their planned routes, and at E_MAIN (bs=128 bf16, random
    inputs) on both, the first design's time beside the new one's. Returns
    the first design's row at E_MAIN."""
    for k, cin, cin2, cout, n, h, w, dtype, out_dtype, ties in E_CASES:
        key = (k, cin, cin2, cout, h, w)
        _e_case(gen, dev, key, n, dtype, out_dtype, ties)
        print(f"kernel int8_conv case {h}x{w}x{cin}{f'+{cin2}' if cin2 else ''}->{cout} k={k} "
              f"n={n} {dtype}->{out_dtype}{' ties' if ties else ''}: bits exact twice; "
              f"{_e_plan_text(key, n, getattr(torch, dtype))}")
    times = {}
    for route in ("wgmma", "mma_sync"):
        args, kw = _e_case(gen, dev, E_MAIN, BATCH, "bfloat16", "bfloat16", False, route)
        times[route] = _sync_ms(lambda: int8_e._launch(
            *args, None, None, None, kw["out_dtype"], False, route=route), 10)
    plain = _sync_ms(lambda: int8_e.int8_conv_plain(*args, **kw), 2, 1)
    print(f"kernel int8_conv routes at {E_MAIN[4]}x{E_MAIN[5]}x{E_MAIN[1]}->{E_MAIN[3]} "
          f"bs={BATCH} bf16: bits exact on both; wgmma {times['wgmma']:.4f} ms, mma_sync "
          f"{times['mma_sync']:.4f} ms, plain {plain:.4f} ms")
    return {"ms": times["mma_sync"], "wgmma_ms": times["wgmma"], "plain_ms": plain}


def gn_preset_chains(randn, dev, name: str, batch: int) -> None:
    """Kernels C and C′ at every GroupNorm-chain shape of a preset's U-Net
    (its 8x8 level included), at a small batch: bf16, FiLM, p=0.1, each on
    its planned route and the other one, twice for identical bits, with
    _gn_vs_plain's tolerances. A shape kernel C does not take
    (``fused_gn.supported``) runs the composed chain on the model's kernel
    route; those are listed."""
    cfg = preset(name)
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0),
                                          device="cpu").to(dev).eval()
    shapes = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, a: shapes.append((a[0].shape[2], a[0].shape[3], a[0].shape[1], mod.groups)))
        for mod in model.unet.modules() if isinstance(mod, EDMGroupNorm)]
    with torch.no_grad():
        model.unet(torch.zeros(1, *cfg.data.resolution, cfg.model.input_channels, device=dev))
    for h in hooks:
        h.remove()
    taken = sorted({sh for sh in shapes if fused_gn.supported(*sh)})
    composed = sorted({sh for sh in shapes if not fused_gn.supported(*sh)})
    print(f"{name}: {len(shapes)} GroupNorm chains; (H, W, C, groups) kernel C takes: "
          f"{taken}; composed: {composed}")
    for h, w, c, _ in taken:
        _gn_vs_plain(randn, dev, (batch, h, w, c), "bfloat16", True, 0.1)
        torch.cuda.empty_cache()
    del model


def _gn_vs_plain(randn, dev, shape, dtype, film: bool, p_drop: float,
                 silu: bool = True, timed: bool = True) -> dict:
    """Kernels C and C′ against their plain versions at one shape: every
    output and the masks, each kernel on its planned route and on the
    other one (for C the three passes where the plan takes a cluster and
    the shape's cluster layout where it takes three passes; for C′ two
    passes or the cluster layout), each run twice for identical bits;
    times, bounds, and ``F.group_norm``'s time at the shape as a note (it
    computes only the normalization, not the chain, so it is no
    ``library_ms``). Without ``timed`` the times read nan."""
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
    consts = (groups, 1e-5, p_drop, silu)
    want = fused_gn.gn_film_silu_dropout_plain(*args, *consts)
    plan = fused_gn.fwd_plan(h * w, c, groups, size)
    fwd = [_gn_fwd_route(args, consts, want, pl, timed)
           for pl in ((plan,) if plan == fused_gn.THREE_PASS else (plan, fused_gn.THREE_PASS))]
    y, mean, rstd = fwd[0].pop("result")
    for r in fwd[1:]:
        del r["result"]
    # the public entry takes the planned route
    if not torch.equal(fused_gn.gn_film_silu_dropout_fwd(*args, *consts)[0], y):
        raise AssertionError("kernel C's entry point left its planned route")
    # the backward of both on the kernel's statistics: C′ on the shape's plan
    # and on the other route, each held to the plain version
    bwd_args = (x, g, gamma, beta, scale, shift, seed, mean, rstd, groups, p_drop, silu)
    want_bwd = fused_gn.gn_film_silu_dropout_bwd_plain(*bwd_args)
    plan = fused_gn.bwd_plan(h * w, c, groups, size)
    other = (fused_gn.TWO_PASS if plan["route"] == "cluster"
             else fused_gn.cluster_plan(h * w, c, groups, size))
    routes = [_gn_bwd_route(bwd_args, want_bwd, pl, timed) for pl in (plan, other)
              if pl is not None]
    plain_ms = bwd_plain_ms = gn_ms = gn_fb_ms = math.nan
    if timed:
        plain_ms = _sync_ms(lambda: fused_gn.gn_film_silu_dropout_plain(*args, *consts), 2, 1)
        bwd_plain_ms = _sync_ms(lambda: fused_gn.gn_film_silu_dropout_bwd_plain(*bwd_args),
                                2, 1)
        xr = x.detach().permute(0, 3, 1, 2).requires_grad_()  # NCHW view, channels_last
        wr, br = gamma.to(tdt).requires_grad_(), beta.to(tdt).requires_grad_()
        gr = g.permute(0, 3, 1, 2)
        with torch.no_grad():
            gn_ms = _sync_ms(lambda: F.group_norm(xr, groups, wr, br, 1e-5), 20)
        gn_fb_ms = _sync_ms(lambda: torch.autograd.grad(
            F.group_norm(xr, groups, wr, br, 1e-5), (xr, wr, br), gr), 10)
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
              f"silu={silu} {'planned' if i == 0 else 'other  '} plan={json.dumps(r['plan'])} "
              f"bit_reproducible=True masks_equal={r['masks_equal']} "
              f"kept_zeros={r['kept_zeros']} keep_rate={r['keep']:.6f} "
              f"max_err/max={json.dumps(r['err'])} max_abs_err={r['abs_err']:.3e} "
              f"kernel_ms={r['ms']:.4f} no_silu_no_mask_ms={r['bare_ms']:.4f}")
    print(f"kernel fused_gn        shape={shape} {dtype:8s} plain_ms={plain_ms:.4f} "
          f"bound_ms={fwd_bound['bound_ms']:.4f} ({fwd_bound['bound_by']}) "
          f"F.group_norm_ms={gn_ms:.4f}")
    for i, r in enumerate(routes):
        print(f"kernel fused_gn_bwd    shape={shape} {dtype:8s} film={film} p={p_drop} "
              f"silu={silu} {'planned' if i == 0 else 'other  '} plan={json.dumps(r['plan'])} "
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


def _gn_fwd_route(args, consts, want, plan: dict, timed: bool = True) -> dict:
    """Kernel C on one plan of its shape: run twice for identical bits; y,
    mean, rstd and the dropout mask against the plain forward; with
    ``timed`` its time, and its time with the chain's SiLU and mask off
    (the route's memory traffic and structure alone), else nan.
    ``result`` holds its outputs."""
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
           "ms": _sync_ms(run, 20) if timed else math.nan,
           "bare_ms": (_sync_ms(lambda: run((consts[0], consts[1], 0.0, False)), 20)
                       if timed else math.nan)}
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


def _gn_bwd_route(bwd_args, want, plan: dict, timed: bool = True) -> dict:
    """Kernel C′ on one plan of its shape: run twice for identical bits,
    every output against the plain backward; with ``timed`` its time, and
    its time with the chain's SiLU and mask off (the route's memory
    traffic and structure alone), else nan."""
    def run(args=bwd_args):
        return fused_gn._launch_bwd(*args, plan=plan)

    got, again = run(), run()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"kernel C′ is not bit-reproducible on plan {plan}")
    names = ("dx", "dgamma", "dbeta", "dscale", "dshift")
    out = {"plan": dict(plan),
           "err": {k: _max_err_ratio(u.float(), v.float()) for k, u, v in zip(names, got, want)},
           "abs_err": max(float((u.float() - v.float()).abs().max()) for u, v in zip(got, want)),
           "ms": _sync_ms(run, 20) if timed else math.nan,
           "bare_ms": _sync_ms(lambda: run((*bwd_args[:10], 0.0, False)), 20) if timed
           else math.nan}
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
    # the eval steps on the device-resident batches, then eval_model over the
    # same days as a host-side dataset, the batches prefetched to the card
    # as the Trainer's validation reads them (its rate includes that ingest)
    for fused, step in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, hr in enumerate(batches):
            step(hr, stats, torch.Generator(device=dev).manual_seed(100 + i))
        torch.cuda.synchronize()
        rate = len(batches) * BATCH / (time.perf_counter() - t0)
        name = "fused" if fused else "unfused"
        res[f"eval_{name}_device_resident_samples_per_s"] = rate
        print(f"eval step {name} on device-resident batches: samples/s={rate:.2f}")
    ds = ClimexDataset(hr=torch.cat(batches).cpu().numpy(), variables=cfg.data.variables,
                       lowres_scale=cfg.data.lowres_scale, device=dev)
    cfg = copy.deepcopy(cfg)
    cfg.train.batch_size = BATCH
    state = TrainState(model=model, optimizer=None)
    for fused, step in steps.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eval_model(step, state, ds, stats, cfg)
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
                        dev: torch.device, routes=(True, False), sensitivity: bool = True,
                        what: str = "") -> None:
    """The f32 training step on the card (kernels A, A′, D and B, B′ on
    the unfused route) against the CPU (plain versions): two items,
    dropout 0.1, the same noise and seed words, beta_1 = 1. Loss and every
    parameter's gradient, then the parameters after one AdamW step.
    ``routes``: the values of ``fused`` run; ``sensitivity``: also print
    the CPU gradients' change under a 1e-6 move of the inputs; ``what``:
    the model's label in the printed lines."""
    eps = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (cfg.train.ensemble_size, 2, cfg.model.latent_dim)).astype(np.float32))
    seeds = torch.from_numpy(np.random.default_rng(12).integers(
        -2 ** 31, 2 ** 31, (len(model32.unet.dropout_blocks), 2), dtype=np.int32))
    for fused in routes:
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
            if where == "cpu" and fused and sensitivity:
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
        print(f"device vs cpu f32 train step{what and ' ' + what} fused={fused}: loss "
              f"cuda={lg:.7g} cpu={lc:.7g} "
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
                  ("B afcrps fwd", ("afcrps_tile_", "afcrps_reduce_kernel")),
                  ("B' afcrps bwd", ("afcrps_bwd_",)),
                  ("C fused_gn fwd", ("gn_fwd_",)),
                  ("C' fused_gn bwd", ("gn_bwd_",)),
                  ("D dropout", ("dropout_kernel",)),
                  ("E int8_conv", ("int8_conv_kernel", "int8_conv_wgmma_kernel")),
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


def _peak_rss_gb(who: int = resource.RUSAGE_SELF) -> float:
    return resource.getrusage(who).ru_maxrss / 1e6     # kB on Linux


def _run_cli(argv: list[str], platform: str | None = None):
    """``cli.main(argv)`` in this process (under ``PROBUNET_PLATFORM=platform``
    when given) with its standard output captured and echoed, long lines
    cut; returns (its result, its output, host seconds, this process's
    peak RSS in GB after it)."""
    saved = os.environ.get("PROBUNET_PLATFORM")
    if platform is not None:
        os.environ["PROBUNET_PLATFORM"] = platform
    buf = io.StringIO()
    rss0 = _peak_rss_gb()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            result = cli.main(argv)
    finally:
        if saved is None:
            os.environ.pop("PROBUNET_PLATFORM", None)
        else:
            os.environ["PROBUNET_PLATFORM"] = saved
    seconds = time.perf_counter() - t0
    rss = _peak_rss_gb()
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"  | {line[:200]}{' ...' if len(line) > 200 else ''}")
    print(f"  host {seconds:.3f} s; this process's peak RSS {rss0:.3f} GB before, "
          f"{rss:.3f} GB after")
    return result, text, seconds, rss


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cli_breakdown(name: str, sets: list[str], ckpt: str, bs: int, m: int,
                  dev: torch.device) -> None:
    """Where one batch of ``evaluate``'s metric pass goes: CUDA events
    around the command's per-batch work (host slice and copy, ``sample``,
    ``residual_to_hr``, the inverse transform, ``EvalAccumulator.update``
    with its copy of the partials to the host), and torch.profiler's kernel
    time by family over two batches."""
    cfg = cli.build_config(argparse.Namespace(preset=CLI_PRESET, config=None, set=sets))
    _, _, ds = cli.make_datasets(cfg, splits=(2,), device=dev)
    model = cli._load_model(cfg, ckpt, dev)
    idx = np.arange(bs)
    eps = cli.batch_noise(cli.EVAL_SEED, 0, m, bs, cfg.model.latent_dim)
    acc = EvalAccumulator()

    def run():
        acc.update(*cli._sample_hr(model, ds, cfg, idx, eps))

    with torch.inference_mode():
        batch_ms = _sync_ms(run, 5, 2, spin=False)
        _print_groups(f"cli breakdown {name} batch", *_kernel_ms_by_group(run, 2), batch_ms)
    print(f"cli breakdown {name}: {batch_ms:.3f} ms a batch (CUDA events), "
          f"{bs * 1e3 / batch_ms:.2f} days/s, {bs * m * 1e3 / batch_ms:.2f} member-fields/s")


def _workdir(path: str | None, prefix: str):
    """``path`` (kept after the phase) or a temporary directory."""
    if path is not None:
        os.makedirs(path, exist_ok=True)
        return contextlib.nullcontext(path)
    return tempfile.TemporaryDirectory(prefix=prefix)


def cli_phase(dev: torch.device, zero_counts, read_counts, workdir: str | None = None) -> dict:
    """The serve CLI as users run it, through ``cli.main``: ``pack`` of the
    flagship's test split, a checkpoint of a seeded flagship model,
    ``evaluate`` at the defaults (f32, M=16, bs=16) and as ``bench.py``
    serves (bf16, bs=128), ``extremes``, then ``evaluate`` and ``extremes``
    on 32 days on the card against the CPU. Every U-Net chain of every
    served batch goes through kernel C. Returns each run's kernel launches.
    ``workdir``: where the packed split (``test.npz``) is written and kept,
    else a temporary directory."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"cli: matplotlib {'present' if have_mpl else 'absent'} on this host")
    launches = {}
    with _workdir(workdir, "chip_smoke_cli_") as tmp:
        packed = os.path.join(tmp, "test.npz")
        cfg = cli.build_config(argparse.Namespace(preset=CLI_PRESET, config=None, set=[]))
        # pack in a process of its own, as a user runs it: the synthetic
        # generator's peak host memory is its own, not the serve runs'
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "probunet_tpu_torch", "pack", "--preset", CLI_PRESET,
             "--split", "test", "--out", packed], capture_output=True, text=True,
            timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)),
            env={k: v for k, v in os.environ.items() if k != "PROBUNET_PLATFORM"})
        sec = time.perf_counter() - t0
        print(proc.stdout + proc.stderr, end="")
        if proc.returncode:
            raise AssertionError(f"pack exited with {proc.returncode}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        if out["shape"] != [CLI_TEST_DAYS, *cfg.data.resolution, len(cfg.data.variables)]:
            raise AssertionError(f"packed test split of shape {out['shape']}")
        print(f"cli pack: {out['shape']} in {sec:.3f} s (process start included), "
              f"{os.path.getsize(packed) / 1e6:.1f} MB, peak RSS of the largest child so far "
              f"(pack or nvcc) {_peak_rss_gb(resource.RUSAGE_CHILDREN):.3f} GB")

        gen = torch.Generator().manual_seed(0)
        model = ProbabilisticUNet.from_config(cfg, gen, device="cpu")
        _fill_zero_params(model, gen)
        chains = 2 * len(model.unet.dropout_blocks) + 1     # GroupNorm chains a forward
        ckpt = os.path.join(tmp, "ckpt")
        CheckpointManager(ckpt).save_best(model.state_dict())
        del model
        serve = ["--preset", CLI_PRESET, "--ckpt", ckpt, "--set",
                 f"data.packed_test={packed}"]

        # timed runs under torch's default math flags (TF32 convolutions),
        # as a user's f32 run gets them; the checks below turn TF32 off
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
        print("cli timed runs: matmul.allow_tf32=False cudnn.allow_tf32=True (torch defaults)")
        m = 16
        runs = (("evaluate f32 bs=16", [], 16), ("evaluate bf16 bs=128",
                                                  ["model.compute_dtype=bfloat16"], 128))
        for name, sets, bs in runs:
            items = CLI_TEST_DAYS // bs * bs
            zero_counts()
            (res, spans), text, sec, rss = _run_cli(
                ["evaluate", *serve, *sets, "--batch-size", str(bs),
                 "--outdir", os.path.join(tmp, name.split()[1])])
            launches[name] = read_counts()
            n = launches[name]["fused_gn"]
            forwards = 2 * res["items"] // bs     # the metric pass and the histogram pass
            print(f"cli {name}: items={res['items']} M={res['members']}; "
                  + "; ".join(f"{v} crps={c:.6g} mae={a:.6g} spread={sp:.6g}"
                              for v, c, a, sp in zip(cfg.data.variables, res["crps_mean"],
                                                     res["mae_mean"], res["spread"]))
                  + f"; timing {json.dumps({k: round(v, 4) for k, v in spans.items()})}; "
                  f"metric loop {res['items'] / spans['metric_loop']:.2f} days/s, "
                  f"{res['items'] * m / spans['metric_loop']:.2f} member-fields/s; "
                  f"C launches {n} for {forwards} U-Net forwards; host {sec:.3f} s; "
                  f"peak RSS {rss:.3f} GB")
            if res["items"] != items:
                raise AssertionError(f"{name} served {res['items']} days, not {items}")
            if not all(math.isfinite(v) for k in ("crps_mean", "mae_mean", "spread")
                       for v in res[k]):
                raise AssertionError(f"{name}: non-finite metrics {res}")
            if n != chains * forwards:
                raise AssertionError(f"{name}: {n} C launches for {forwards} U-Net forwards")
            if ("figures skipped" in text) == have_mpl:
                raise AssertionError(f"{name}: figures {'skipped' if have_mpl else 'drawn'} "
                                     f"with matplotlib {'present' if have_mpl else 'absent'}")

        for name, sets, bs in runs:
            cli_breakdown(name, serve[-1:] + sets, ckpt, bs, m, dev)

        zero_counts()
        (res, spans), text, sec, rss = _run_cli(
            ["extremes", *serve, *CLI_EXTREMES, "--outdir", os.path.join(tmp, "extremes")])
        launches["extremes f32 bs=32"] = read_counts()
        n = launches["extremes f32 bs=32"]["fused_gn"]
        days, per_year = CLI_TEST_DAYS // 32 * 32, res["days_per_year"]
        print(f"cli extremes: days={res['days']} of {res['days_requested']} M={res['members']} "
              f"timing {json.dumps({k: round(v, 4) for k, v in spans.items()})}; sample loop "
              f"{res['days'] / spans['sample_loop']:.2f} days/s; C launches {n} for "
              f"{res['days'] // 32} U-Net forwards; host {sec:.3f} s; peak RSS {rss:.3f} GB")
        for name, px in res["pixels"].items():
            for side in ("observed", "model"):
                r = px[side]
                print(f"cli extremes {name} {side}: {len(r['block_maxima'])} annual maxima, "
                      f"gev {r['gev_fit']}, return levels {r['return_levels']} "
                      f"(T={res['return_periods']}), CI {r['ci_lower']} .. {r['ci_upper']}, "
                      f"{r['bootstrap_valid']} valid / {r['bootstrap_failed']} failed refits")
                if len(r["block_maxima"]) != days // per_year:
                    raise AssertionError(f"{name} {side}: {len(r['block_maxima'])} maxima")
                if not np.isfinite(r["return_levels"]).all():
                    raise AssertionError(f"{name} {side}: non-finite return levels")
        if res["days"] != days or n != chains * (days // 32):
            raise AssertionError(f"extremes served {res['days']} days with {n} C launches")
        if ("plotting skipped" in text) == have_mpl:
            raise AssertionError("extremes: figures and matplotlib disagree")

        launches.update(cli_int8_runs(serve, ckpt, tmp, chains, zero_counts, read_counts))

        # f32 on the card (kernels, TF32 off) against the CPU (plain versions)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        got = {}
        for where in (None, "cpu"):
            ev = _run_cli(["evaluate", *serve, *CLI_CHECK_EVAL,
                           "--outdir", os.path.join(tmp, f"check_{where}")], where)[0][0]
            ex = _run_cli(["extremes", *serve, *CLI_CHECK_EXTREMES,
                           "--outdir", os.path.join(tmp, f"check_{where}")], where)[0][0]
            got[where] = (ev, ex)
        (ev_g, ex_g), (ev_c, ex_c) = got[None], got["cpu"]
        errs = {k: _rel(ev_g[k], ev_c[k]) for k in ("crps_mean", "crps_std", "mae_mean",
                                                     "spread")}
        for name in ex_c["pixels"]:
            for side in ("observed", "model"):
                errs[f"{name} {side} series"] = _rel(ex_g["pixels"][name][side]["block_maxima"],
                                                     ex_c["pixels"][name][side]["block_maxima"])
        print(f"cli f32 card vs cpu, max|err|/max|cpu| (limit {ENSEMBLE_RTOL}): "
              f"{json.dumps(errs)}")
        if ev_g["items"] != ev_c["items"] or ex_g["days"] != ex_c["days"]:
            raise AssertionError("the card and the CPU served different days")
        bad = {k: v for k, v in errs.items() if not v <= ENSEMBLE_RTOL}
        if bad:
            raise AssertionError(f"the CLI on the card differs from the CPU: {bad}")
        infer_domain_device_vs_cpu(ckpt, tmp)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return launches


def _domain_argv(ckpt: str, outdir: str, extra: list[str]) -> list[str]:
    return ["infer-domain", "--preset", "fulldomain_dp8", "--ckpt", ckpt, "--outdir", outdir,
            *extra, "--set", f"data.years_test={json.dumps(INFER_DOMAIN_YEARS)}"]


def cli_int8_runs(serve: list[str], ckpt: str, tmp: str, chains: int, zero_counts,
                  read_counts) -> dict:
    """``--quant int8 --quant-skip heads`` through ``cli.main``: ``evaluate``
    at bf16 bs=128 over the packed split (calibrated on a two-year
    validation split), ``extremes`` at its defaults, and ``infer-domain
    --preset fulldomain_dp8`` (4 days, 32 members, 16 tiles a chunk) in
    float and int8: metrics, seconds, tiles/s, E and C launches (85 E a
    U-Net forward served int8; the calibration's forwards run float).
    Returns each run's launches."""
    t0 = time.perf_counter()
    launches = {}
    val = [f"data.years_val={json.dumps(INT8_VAL_YEARS)}"]
    per_fwd = INT8_SAMPLE_LEAVES - INT8_SAMPLE_SPLIT - INT8_HEADS
    bs = 128
    zero_counts()
    (res, spans), text, sec, rss = _run_cli(
        ["evaluate", *serve, "model.compute_dtype=bfloat16", *val, *INT8_FLAGS,
         "--batch-size", str(bs), "--outdir", os.path.join(tmp, "int8_eval")])
    launches["evaluate int8 bf16 bs=128"] = n = read_counts()
    forwards = 2 * res["items"] // bs
    print(f"cli int8 evaluate bf16 bs={bs}: items={res['items']}; "
          + "; ".join(f"{v} crps={c:.6g} mae={a:.6g}" for v, c, a in
                      zip(CLI_VARIABLES, res["crps_mean"], res["mae_mean"]))
          + f"; timing {json.dumps({k: round(v, 4) for k, v in spans.items()})}; metric loop "
          f"{res['items'] / spans['metric_loop']:.2f} days/s, "
          f"{res['items'] * res['members'] / spans['metric_loop']:.2f} member-fields/s; "
          f"E launches {n['int8_conv']}, C {n['fused_gn']} for {forwards} served forwards "
          f"and the calibration's; host {sec:.3f} s")
    calib = _int8_lines(text, "val-split batches")
    if not all(math.isfinite(v) for k in ("crps_mean", "mae_mean", "spread") for v in res[k]):
        raise AssertionError(f"int8 evaluate: non-finite metrics {res}")
    if calib != INT8_CALIB_BATCHES or n["int8_conv"] != per_fwd * forwards or \
            n["fused_gn"] != chains * (forwards + calib):
        raise AssertionError(f"int8 evaluate: {n['int8_conv']} E, {n['fused_gn']} C launches")

    zero_counts()
    (res, spans), text, sec, rss = _run_cli(
        ["extremes", *serve, *val, *INT8_FLAGS, *INT8_EXTREMES,
         "--outdir", os.path.join(tmp, "int8_extremes")])
    launches["extremes int8 f32 bs=32"] = n = read_counts()
    forwards = res["days"] // 32
    print(f"cli int8 extremes: days={res['days']} timing "
          f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; sample loop "
          f"{res['days'] / spans['sample_loop']:.2f} days/s; E launches {n['int8_conv']}, C "
          f"{n['fused_gn']}; host {sec:.3f} s")
    calib = _int8_lines(text, "val-split batches")
    for name, px in res["pixels"].items():
        r = px["model"]
        print(f"cli int8 extremes {name} model: gev {r['gev_fit']}, return levels "
              f"{r['return_levels']}")
        if not np.isfinite(r["return_levels"]).all():
            raise AssertionError(f"int8 extremes {name}: non-finite return levels")
    if calib != INT8_CALIB_BATCHES or n["int8_conv"] != per_fwd * forwards or \
            n["fused_gn"] != chains * (forwards + calib):
        raise AssertionError(f"int8 extremes: {n['int8_conv']} E, {n['fused_gn']} C launches")

    m, days, chunk = 32, 4, 16
    domain = {}
    for name, flags in (("float", []), ("int8", INT8_FLAGS)):
        zero_counts()
        (res, spans), text, sec, rss = _run_cli(_domain_argv(
            ckpt, os.path.join(tmp, f"domain_{name}"),
            ["--days", str(days), "--members", str(m), "--batch-tiles", str(chunk), *flags]))
        launches[f"infer-domain {name}"] = n = read_counts()
        tiles = res["days"] * res["tiles_per_day"]
        chunks = -(-tiles // chunk)
        calib = _int8_lines(text, "tile chunks") if flags else 0
        domain[name] = res
        print(f"cli infer-domain fulldomain_dp8 {name}: domain {res['domain']}, {res['days']} "
              f"days x {res['tiles_per_day']} tiles, M={res['members']}; crps "
              f"{res['crps_mean']} mae {res['mae_mean']}; timing "
              f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; "
              f"{tiles / spans['sample']:.2f} tiles/s, "
              f"{tiles * m / spans['sample']:.2f} member-fields/s; E launches "
              f"{n['int8_conv']}, C {n['fused_gn']} ({chunks} chunks, {calib} calibration "
              f"chunks); host {sec:.3f} s")
        if (res["tiles_per_day"], res["days"], res["members"]) != (9, days, m) or \
                calib != (min(INT8_CALIB_BATCHES, chunks) if flags else 0):
            raise AssertionError(f"infer-domain {name}: {res}")
        if not all(math.isfinite(v) for k in ("crps_mean", "mae_mean") for v in res[k]):
            raise AssertionError(f"infer-domain {name}: non-finite metrics {res}")
        if n["int8_conv"] != (per_fwd * chunks if flags else 0) or \
                n["fused_gn"] != chains * (chunks + calib):
            raise AssertionError(f"infer-domain {name}: {n['int8_conv']} E, {n['fused_gn']} C")
    rel = _rel(domain["int8"]["crps_mean"], domain["float"]["crps_mean"])
    print(f"cli infer-domain int8 vs float crps max rel {rel:.4g}; cli int8 runs "
          f"{time.perf_counter() - t0:.3f} s")
    return launches


def _int8_lines(text: str, where: str) -> int:
    """The JAX CLI's two calibration lines, with the flagship's counts;
    returns the number of calibration batches they name."""
    lines = [ln for ln in text.splitlines() if ln.startswith("int8 serve")]
    n0 = INT8_SAMPLE_LEAVES
    want = [f"int8 serve: --quant-skip ['heads'] pruned {INT8_HEADS} of {n0} scales",
            f"int8 serve: calibrated {n0 - INT8_HEADS} conv scales on "]
    if len(lines) != 2 or lines[0] != want[0] or not lines[1].startswith(want[1]) \
            or not lines[1].endswith(where):
        raise AssertionError(f"int8 calibration lines {lines}")
    return int(lines[1][len(want[1]):].split()[0])


def infer_domain_device_vs_cpu(ckpt: str, tmp: str) -> None:
    """``infer-domain`` on a 140x140 domain (4 tiles a day, 2 days, M=4),
    float and int8, on the card (TF32 off) against the CPU: float within
    ENSEMBLE_RTOL; the int8 metrics within SERVE_SHARE of the CPU's
    int8-vs-float gap (a flipped rounding moves a domain mean little), finite,
    with the same calibration lines."""
    t0 = time.perf_counter()
    extra = ["--domain", "140", "--days", "2", "--members", "4", "--batch-tiles", "4"]
    got = {}
    for where in (None, "cpu"):
        for name, flags in (("float", []), ("int8", INT8_FLAGS)):
            (res, _), text, _, _ = _run_cli(_domain_argv(
                ckpt, os.path.join(tmp, f"domain_check_{where}_{name}"), extra + flags), where)
            got[(where, name)] = res
            if flags:
                _int8_lines(text, "tile chunks")
    nums = {k: np.array(v["crps_mean"] + v["mae_mean"], np.float64) for k, v in got.items()}
    err_f = _rel(nums[(None, "float")], nums[("cpu", "float")])
    err_q = float(np.abs(nums[(None, "int8")] - nums[("cpu", "int8")]).max())
    gap = float(np.abs(nums[("cpu", "int8")] - nums[("cpu", "float")]).max())
    print(f"cli infer-domain card vs cpu (140x140, f32): float max|err|/max|cpu|={err_f:.3e} "
          f"(limit {ENSEMBLE_RTOL}); int8 max|err|={err_q:.4g}, cpu int8-vs-float gap "
          f"{gap:.4g}, share {err_q / gap:.4g} (limit {SERVE_SHARE}); "
          f"{time.perf_counter() - t0:.3f} s")
    if not err_f <= ENSEMBLE_RTOL:
        raise AssertionError(f"infer-domain float on the card differs from the CPU: {err_f}")
    if not (np.isfinite(nums[(None, "int8")]).all() and gap > 0 and err_q <= SERVE_SHARE * gap):
        raise AssertionError(f"infer-domain int8 on the card against the CPU: {err_q} over a "
                             f"gap of {gap}: {got[(None, 'int8')]}")


def _prefetch_bit_equal(ds, bs: int, seed: int, dev: torch.device) -> int:
    """One epoch of ``ds`` through ``prefetch_to_device``, the consumer's
    stream kept busy between batches as a training step keeps it, each
    prefetched batch held bit for bit against a synchronous copy of the
    same indices. Returns the batches compared."""
    batches = list(Batches(len(ds), bs, shuffle=True, seed=seed))
    busy = torch.randn((PREFETCH_BUSY_N, PREFETCH_BUSY_N), device=dev)
    n = 0
    for idx, got in zip(batches, prefetch_to_device((ds.get_hr_batch(i) for i in batches),
                                                    device=dev)):
        for _ in range(4):      # ~1 ms of the consumer's stream, as a step holds it
            busy = (busy @ busy).clamp_(-1, 1)
        want = torch.from_numpy(np.ascontiguousarray(ds.get_hr_batch(idx))).to(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"prefetched batch {n} differs from its synchronous copy")
        n += 1
    if n != len(batches):
        raise AssertionError(f"the prefetch yielded {n} of {len(batches)} batches")
    return n


def _host_batch_ms(ds, bs: int, dev: torch.device) -> dict:
    """The host's work per batch of one epoch: the random-row gather
    (``get_hr_batch``) and the prefetch's pin and enqueue (each ``next`` of
    the prefetch less the gather it pulls), in ms, mean and max."""
    gather = []

    def timed():
        for idx in Batches(len(ds), bs, shuffle=True, seed=1):
            t0 = time.perf_counter()
            hr = ds.get_hr_batch(idx)
            gather.append(time.perf_counter() - t0)
            yield hr

    nexts = []
    it = prefetch_to_device(timed(), device=dev)
    while True:
        t0 = time.perf_counter()
        n0 = len(gather)
        try:
            next(it)
        except StopIteration:
            break
        dt = time.perf_counter() - t0
        nexts.append(dt - sum(gather[n0:]))
    torch.cuda.synchronize()
    g, p = np.array(gather) * 1e3, np.array(nexts) * 1e3
    return {"gather_ms_mean": float(g.mean()), "gather_ms_max": float(g.max()),
            "pin_enqueue_ms_mean": float(p.mean()), "pin_enqueue_ms_max": float(p.max()),
            "batches": len(nexts), "mb_per_batch": ds.get_hr_batch(np.arange(bs)).nbytes / 1e6}


def _epoch_idle_share(trainer, cfg) -> dict:
    """``IDLE_EPOCHS`` training epochs of ``trainer`` after the epochs
    already run, under torch.profiler: the device's kernel time (copies and
    memsets excluded) and the wall time of those same epochs, and the share
    of it the device ran no kernel (the tracing's own host cost included).
    Then as many epochs without the profiler, for the rate alone."""
    steps = IDLE_EPOCHS * (len(trainer.dataset_train) // cfg.train.batch_size)

    def epochs(seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(IDLE_EPOCHS):
            trainer.state, _ = train_epoch(trainer.train_step, trainer.state,
                                           trainer.dataset_train, trainer.stats, cfg,
                                           1.0, 0.0, seed + e)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # device activity only: recording every host op would lengthen the
    # host-bound gaps the share measures
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_prof = epochs(90)
    busy = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.self_cpu_time_total != 0 or dev_us <= 0 or e.key.startswith(("Memcpy", "Memset")):
            continue
        busy += dev_us / 1e6
    if busy <= 0:
        raise AssertionError("the profiler saw no device time in the epochs")
    wall = epochs(95)
    samples = steps * cfg.train.batch_size
    return {"epochs": IDLE_EPOCHS, "steps": steps, "kernel_s": busy,
            "wall_s_profiled": wall_prof, "idle_share_profiled": 1 - busy / wall_prof,
            "samples_per_s_profiled": samples / wall_prof, "wall_s": wall,
            "samples_per_s": samples / wall, "step_ms": wall * 1e3 / steps}


def _chain_routes(model: torch.nn.Module, x: torch.Tensor) -> tuple[dict, set]:
    """The GroupNorm chains of one training forward of ``model`` by route:
    ``C`` (kernel C, ``fused_gn.supported``), ``D`` (the composed chain with
    kernel D's dropout), ``other_dropout`` (a shape D does not take),
    ``composed`` (no dropout). Each chain's route follows the JAX module's
    rule on its shape. Also each chain's (route, NHWC shape, dtype, FiLM,
    p, SiLU), as a set."""
    routes, specs = collections.Counter(), set()

    def pre(mod, args, kwargs):
        h, w, c = args[0].shape[2], args[0].shape[3], args[0].shape[1]
        p = kwargs.get("drop_p", 0.0)
        nhwc = (args[0].shape[0], h, w, c)
        if mod.gn_impl == "kernel" and fused_gn.supported(h, w, c, mod.groups):
            route = "C"
        elif p > 0:
            route = "D" if dropout.supported(nhwc) else "other_dropout"
        else:
            route = "composed"
        routes[route] += 1
        specs.add((route, nhwc, str(args[0].dtype).removeprefix("torch."),
                   kwargs.get("film") is not None, p, bool(kwargs.get("silu", False))))

    hooks = [m.register_forward_pre_hook(pre, with_kwargs=True) for m in model.modules()
             if isinstance(m, EDMGroupNorm)]
    with torch.no_grad():
        model(x, train=True, generator=torch.Generator(device=x.device).manual_seed(3))
    for h in hooks:
        h.remove()
    return dict(routes), specs


def new_branches_device_vs_cpu(dev: torch.device) -> None:
    """The ELBO branches and the step this slice adds, f32, on the card (TF32
    off) against the CPU on the same weights, inputs, noise and seed words:
    the WMSE + MS-SSIM ELBO on the flagship model (128x128, M=15) and the
    L1 ELBO (beta_2 > 0) on the ``deterministic_64`` model, loss and every
    parameter's gradient (two items, dropout on); one deterministic step of
    each ``train-det`` model at ``deterministic_64``'s widths and batch (8
    items, so every chain takes the route it takes in ``train-det``): its
    per-variable losses, every parameter's gradient as the step hands it to
    AdamW, and the share of weights that stepped the other way. Limits:
    DEVICE_RTOL, GRAD_RTOL, FLIP_SHARE."""
    gen = torch.Generator().manual_seed(31)
    for name, loss_type, m in (("probunet_multivar_128", "mse+ssim", 15),
                               ("deterministic_64", "l1", None)):
        cfg = preset(name)
        cfg.loss.loss_type = loss_type
        model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0),
                                              device="cpu")
        _fill_zero_params(model, gen)
        hr = apply_physical_transform(torch.from_numpy(synthetic_climex_fields(
            8, *cfg.data.resolution, cfg.data.variables, seed=5)), cfg.data.variables)
        stats = compute_stats(hr, cfg.data.lowres_scale)
        d = cfg.model.latent_dim
        eps = torch.randn((m, 2, d) if m else (2, d), generator=gen)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (len(model.unet.dropout_blocks), 2),
                              generator=gen, dtype=torch.int32)
        out = {}
        for where in ("cpu", dev):
            mdl = copy.deepcopy(model).to(where)
            st = type(stats)(*[t.to(where) for t in stats])
            batch = preprocess_batch(hr[:2].to(where), st, cfg.data.pipeline,
                                     cfg.data.lowres_scale, cfg.data.interp_mode,
                                     cfg.data.epsilon, cfg.data.standardization)
            total, met = mdl.elbo(batch["inputs"], batch["targets"], M=m or 1,
                                  loss_type=loss_type, beta_1=1.0, beta_2=0.5,
                                  eps=eps.to(where), training=True, seeds=seeds.to(where))
            params = list(mdl.parameters())
            grads = torch.autograd.grad(total, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            out[str(where)] = (float(total.detach()),
                               {k: v.detach().cpu() for k, v in met.items()},
                               [g.cpu() for g in grads])
            del mdl, grads, total
        (lc, mc, gc), (lg, mg, gg) = out["cpu"], out[str(dev)]
        names = [n for n, _ in model.named_parameters()]
        grad_err = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for n, a, b in zip(names, gg, gc) if b.norm() > 0}
        worst = max(grad_err, key=grad_err.get)
        met_err = {k: float(((mg[k] - mc[k]).abs() / mc[k].abs().clamp_min(1e-30)).max())
                   for k in mc}
        rel = abs(lg - lc) / abs(lc)
        print(f"device vs cpu f32 {loss_type} ELBO ({name}): loss cuda={lg:.7g} cpu={lc:.7g} "
              f"rel_err={rel:.3e}; metrics rel_err {json.dumps(met_err)}; grads ||dg||/||g|| "
              f"max={grad_err[worst]:.3e} ({worst}), "
              f"median={float(np.median(list(grad_err.values()))):.3e}")
        if not rel <= DEVICE_RTOL or not max(met_err.values()) <= DEVICE_RTOL:
            raise AssertionError(f"the {loss_type} ELBO on the card differs from the CPU")
        if not grad_err[worst] <= GRAD_RTOL:
            raise AssertionError(f"{loss_type}: gradient of {worst} differs from the CPU: "
                                 f"{grad_err[worst]}")
    det_steps_device_vs_cpu(dev, gen)


def det_steps_device_vs_cpu(dev: torch.device, gen: torch.Generator) -> None:
    """One f32 deterministic step of each ``train-det`` model on the card
    against the CPU (see ``new_branches_device_vs_cpu``); weights and seed
    words drawn from ``gen``."""
    cfg0 = preset(DET_PRESET)
    bs = cfg0.train.batch_size
    hr = torch.from_numpy(synthetic_climex_fields(bs, *cfg0.data.resolution,
                                                  cfg0.data.variables, seed=6))
    hr = apply_physical_transform(hr, cfg0.data.variables)
    stats = compute_stats(hr, cfg0.data.lowres_scale)
    for name, sets in DET_VARIANTS:
        cfg = cli.build_config(argparse.Namespace(preset=DET_PRESET, config=None, set=sets))
        kind = "linearcnn" if name == "linearcnn" else "unet"
        model = cli.make_det_model(cfg, kind, "cpu")
        _fill_zero_params(model, gen)
        seeds = (torch.randint(-2 ** 31, 2 ** 31, (len(model.dropout_blocks), 2),
                               generator=gen, dtype=torch.int32)
                 if model.dropout_blocks else None)
        out = {}
        for where in ("cpu", dev):
            state = create_train_state(copy.deepcopy(model), seed=cfg.train.seed,
                                       lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
                                       device=where)
            # the step's own gradients, as it hands them to AdamW
            grads, opt_step = [], state.optimizer.step

            def capture(gs, grads=grads, opt_step=opt_step):
                grads.extend(g.detach().cpu() for g in gs)
                return opt_step(gs)

            state.optimizer.step = capture
            step = make_deterministic_train_step(state.model, cfg)
            st = type(stats)(*[t.to(where) for t in stats])
            state, met = step(state, hr.to(where), st,
                              seeds=None if seeds is None else seeds.to(where))
            out[str(where)] = (met["loss_per_var"].cpu(), grads,
                               [p.detach().cpu() for p in state.optimizer.params])
        (vc, gc, pc), (vg, gg, pg) = out["cpu"], out[str(dev)]
        rel = float(((vg - vc).abs() / vc.abs()).max())
        names = [n for n, _ in model.named_parameters()]
        grad_err = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for n, a, b in zip(names, gg, gc) if b.norm() > 0}
        worst = max(grad_err, key=grad_err.get)
        step_diff = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
        flipped = float((step_diff > cfg.train.lr).float().mean())
        print(f"device vs cpu f32 deterministic step {name} (bs={bs}): loss_per_var "
              f"cuda={vg.tolist()} cpu={vc.tolist()} rel_err={rel:.3e}; grads ||dg||/||g|| "
              f"max={grad_err[worst]:.3e} ({worst}), median="
              f"{float(np.median(list(grad_err.values()))):.3e} over {len(grad_err)} of "
              f"{len(names)} parameters; after AdamW max|dp|={float(step_diff.max()):.3e} "
              f"(lr={cfg.train.lr}), share stepped the other way {flipped:.3e}")
        # a leaf with no gradient on the CPU (the FiLM weights under the zero
        # embedding) has none on the card either: products with 0 are exact
        stray = [n for n, a, b in zip(names, gg, gc) if b.norm() == 0 and a.norm() != 0]
        if stray:
            raise AssertionError(f"{name}: gradients on the card where the CPU has 0: {stray}")
        if not rel <= DEVICE_RTOL or not flipped <= FLIP_SHARE:
            raise AssertionError(f"the deterministic step of {name} on the card differs "
                                 "from the CPU")
        if not grad_err[worst] <= GRAD_RTOL:
            raise AssertionError(f"{name}: gradient of {worst} differs from the CPU: "
                                 f"{grad_err[worst]}")


def _epoch_rates(outdir: str) -> list[float]:
    """Each epoch's ``train_samples_per_sec`` from the run's JSONL log."""
    with open(os.path.join(outdir, "run.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["train_samples_per_sec"] for r in recs if r["kind"] == "epoch"]


def _run_dir(workdir: str, name: str) -> str:
    """The output directory of the training CLI's run ``name``."""
    return os.path.join(workdir, name.replace(" ", "_"))


def train_cli_phase(dev: torch.device, zero_counts, read_counts,
                    workdir: str | None = None) -> dict:
    """The training CLI as users run it, through ``cli.main``: ``pack`` of the
    flagship's train split cut to 1960-1962 (1,095 days) and of its
    validation split cut to 2021; ``train`` at the preset (f32, bs=32,
    M=15, 2 epochs), at bf16 bs=128 (1 epoch) and with the WMSE + MS-SSIM
    ELBO (1 epoch), each checked for kernels A, A′ (afCRPS), C and C′, its
    residual-contribution and final lines; one epoch of prefetched batches
    bit-equal to synchronous copies; the host's work per batch and the
    idle share of three warmed-up epochs at bf16 bs=128. Then
    ``deterministic_64`` at its full widths on 2 packed training years (1
    validation and 1 test year synthetic): ``train`` (the L1 ELBO), ``train-det
    --model unet`` under each U-Net type (C and C′ on every one, D on the
    asymmetric ones; the chains on each route printed, and D, C and C′
    held to their plain versions at every shape and dtype of those
    chains), ``linearcnn`` and ``bcsd`` (its test MAE on the card against
    the CPU). Returns each run's kernel launches. ``workdir``: where the runs
    write (``_run_dir``) and what they write is kept, else a temporary
    directory."""
    launches = {}
    # timed runs under torch's default math flags (TF32 convolutions), as a
    # user's f32 run gets them
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    print("train_cli runs: matmul.allow_tf32=False cudnn.allow_tf32=True (torch defaults)")
    with _workdir(workdir, "chip_smoke_train_") as tmp:
        def pack(preset_name, split, years):
            path = os.path.join(tmp, f"{preset_name}_{split}.npz")
            out = _run_cli(["pack", "--preset", preset_name, "--split", split, "--out", path,
                            "--set", f"data.years_{split}={years}"])[0]
            print(f"train_cli pack {preset_name} {split} {years}: {out['shape']}, "
                  f"{os.path.getsize(path) / 1e6:.1f} MB")
            return path

        t0 = time.perf_counter()
        flag_sets = [f"data.years_train={TRAIN_CLI_YEARS['train']}",
                     f"data.years_val={TRAIN_CLI_YEARS['val']}"]
        for split in ("train", "val"):
            flag_sets.append(f"data.packed_{split}="
                             + pack(CLI_PRESET, split, TRAIN_CLI_YEARS[split]))
        # `pack` draws every split's synthetic fields from one seed, so only
        # the training split is packed here: the validation and test years
        # come from the dataset's own per-split seeds (a BCSD scored on its
        # training fields would read 0)
        det_sets = [f"data.years_{split}={DET_YEARS[split]}" for split in DET_YEARS]
        det_sets.append("data.packed_train=" + pack(DET_PRESET, "train", DET_YEARS["train"]))
        print(f"train_cli packs: {time.perf_counter() - t0:.3f} s")

        have_mpl = importlib.util.find_spec("matplotlib") is not None
        runs = [(f"train {name}", ["train", "--preset", CLI_PRESET, "--set", *flag_sets, *sets])
                for name, sets in TRAIN_CLI_RUNS]
        runs.append(("train deterministic_64 l1", ["train", "--preset", DET_PRESET, "--set",
                                                   *det_sets, "train.num_epochs=1"]))
        runs += [(f"train-det {name}", ["train-det", "--preset", DET_PRESET, "--model",
                                        "linearcnn" if name == "linearcnn" else "unet",
                                        "--set", *det_sets, *sets])
                 for name, sets in DET_VARIANTS]
        runs.append(("train-det bcsd", ["train-det", "--preset", DET_PRESET, "--model", "bcsd",
                                        "--set", *det_sets]))
        results = {}
        for name, argv in runs:
            outdir = _run_dir(tmp, name)
            zero_counts()
            (res, spans), text, sec, rss = _run_cli(argv + ["--outdir", outdir])
            launches[name] = read_counts()
            results[name] = res
            cfg = cli.build_config(argparse.Namespace(
                preset=argv[argv.index("--preset") + 1], config=None,
                set=argv[argv.index("--set") + 1:]))
            bs = cfg.train.batch_size
            if name.startswith("train "):
                rates = _epoch_rates(outdir)
                lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
                if [next(iter(d)) for d in lines] != ["residual_contribution", "final"]:
                    raise AssertionError(f"{name}: the residual_contribution and final lines "
                                         f"were not printed: {lines}")
                if not all(math.isfinite(v) for v in res["final"].values()):
                    raise AssertionError(f"{name}: non-finite losses {res['final']}")
                if ("plotting skipped" in text) == have_mpl:
                    raise AssertionError(f"{name}: the loss curves and matplotlib disagree")
                print(f"train_cli {name}: steps={res['steps']} final={json.dumps(res['final'])} "
                      f"residual_contribution={json.dumps(res['residual_contribution'])}; "
                      f"samples/s by epoch {rates}; timing "
                      f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; "
                      f"host {sec:.3f} s; peak RSS {rss:.3f} GB; launches "
                      f"{json.dumps(launches[name])}")
                need = ["fused_gn", "fused_gn_bwd"]
                if cfg.loss.loss_type == "afcrps":
                    need += ["fcomb_crps", "fcomb_crps_bwd"]
            else:
                print(f"train_cli {name}: {json.dumps(res)}; timing "
                      f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; host "
                      f"{sec:.3f} s; launches {json.dumps(launches[name])}")
                if "bcsd" in name:
                    if not math.isfinite(res["test_mae"]):
                        raise AssertionError(f"bcsd test MAE {res['test_mae']}")
                    continue
                mae = res["test_mae_real_units"]
                if not all(math.isfinite(v) for v in mae.values()):
                    raise AssertionError(f"{name}: test MAE {mae}")
                ds_len = 365 * (DET_YEARS["train"][1] - DET_YEARS["train"][0])
                print(f"train_cli {name}: {ds_len // bs * bs / spans['fit']:.2f} samples/s "
                      f"over the fit phase (bs={bs})")
                need = [] if "linearcnn" in name else ["fused_gn", "fused_gn_bwd"]
                if "asymmetric" in name:
                    need.append("dropout")
            for k in need:
                if launches[name][k] <= 0:
                    raise AssertionError(f"kernel {k} was not launched by {name}")

        # the routes of the deterministic U-Nets' GroupNorm chains, and the
        # launches of one training forward against them
        specs = set()
        for name, sets in DET_VARIANTS:
            if name == "linearcnn":
                continue
            cfg = cli.build_config(argparse.Namespace(preset=DET_PRESET, config=None,
                                                      set=det_sets + sets))
            model = cli.make_det_model(cfg, "unet", dev)
            _, _, ds = cli.make_datasets(cfg, splits=(2,), device=dev)
            batch = ds.preprocess(torch.from_numpy(ds.get_hr_batch(
                np.arange(cfg.train.batch_size))).to(dev))
            zero_counts()
            routes, chains = _chain_routes(model, batch["inputs"])
            n = read_counts()
            specs |= chains
            print(f"train_cli chains of one {name} training forward (bs="
                  f"{cfg.train.batch_size}) by route: {json.dumps(routes)}; launches "
                  f"C={n['fused_gn']} D={n['dropout']}")
            if n["fused_gn"] != routes.get("C", 0) or n["dropout"] != routes.get("D", 0):
                raise AssertionError(f"{name}: launches do not follow the chains' routes")
            if "asymmetric" in name and not routes.get("D"):
                raise AssertionError(f"{name}: no chain on kernel D's route")
        # kernels D, C and C′ against their plain versions at every shape and
        # dtype those chains gave them
        gen = torch.Generator(device=dev).manual_seed(4324)

        def randn(*shape, scale=1.0):
            return scale * torch.randn(shape, generator=gen, device=dev)

        d_specs = sorted({(nhwc, dt, p) for route, nhwc, dt, _, p, _ in specs if route == "D"})
        c_specs = sorted({sp[1:] for sp in specs if sp[0] == "C"})
        print(f"train_cli deterministic chains: {len(d_specs)} (shape, dtype, p) on D, "
              f"{len(c_specs)} (shape, dtype, FiLM, p, SiLU) on C and C′")
        for nhwc, dt, p in d_specs:
            _dropout_vs_plain(randn, nhwc, dt, p, timed=False)
        for nhwc, dt, film, p, silu in c_specs:
            _gn_vs_plain(randn, dev, nhwc, dt, film, p, silu, timed=False)
        torch.cuda.empty_cache()

        # prefetch, host work per batch, idle share: the flagship train split
        cfg = cli.build_config(argparse.Namespace(preset=CLI_PRESET, config=None,
                                                  set=flag_sets + TRAIN_CLI_RUNS[1][1]))
        ds_train, ds_val, _ = cli.make_datasets(cfg, splits=(0, 1), device=dev)
        n = _prefetch_bit_equal(ds_train, 32, cfg.train.seed + 1, dev)
        print(f"train_cli prefetch: {n} batches of 32 of one epoch bit-equal to synchronous "
              f"copies")
        host = _host_batch_ms(ds_train, cfg.train.batch_size, dev)
        trainer = Trainer(cfg, cli.make_model(cfg, dev), ds_train, ds_val, device=dev)
        trainer.fit(1)                      # warm-up epoch
        idle = _epoch_idle_share(trainer, cfg)
        print(f"train_cli host per batch (bs={cfg.train.batch_size}, "
              f"{host['mb_per_batch']:.1f} MB): {json.dumps(host)}; warmed-up epochs bf16 "
              f"(idle share, kernel and wall time from the same profiled epochs): "
              f"{json.dumps(idle)}")

        # bcsd on the card against the CPU
        bcsd = ["train-det", "--preset", DET_PRESET, "--model", "bcsd", "--set", *det_sets,
                "--outdir", os.path.join(tmp, "bcsd_cpu")]
        cpu = _run_cli(bcsd, "cpu")[0][0]
        card = results["train-det bcsd"]
        rel = abs(card["test_mae"] - cpu["test_mae"]) / abs(cpu["test_mae"])
        print(f"train_cli bcsd test MAE card={card['test_mae']!r} cpu={cpu['test_mae']!r} "
              f"rel_err={rel:.3e} (limit {BCSD_RTOL})")
        if not rel <= BCSD_RTOL:
            raise AssertionError(f"bcsd on the card differs from the CPU: {rel}")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return launches


def _edm_model(device) -> EDMPrecond:
    """EDMPrecond at EDM_WIDTHS from a seeded generator, its zero-initialized
    parameters filled (``_fill_zero_params``), on ``device``."""
    gen = torch.Generator().manual_seed(5)
    model = EDMPrecond((128, 128), 6, 3, generator=gen, **EDM_WIDTHS)
    _fill_zero_params(model, gen)
    return model.to(device)


def edm_device_vs_cpu(model_cpu: EDMPrecond, hr: torch.Tensor, stats, cfg,
                      dev: torch.device) -> None:
    """One f32 ``edm_loss`` with its gradients at bs=2, then one
    ``make_edm_train_step`` AdamW step, on the card (kernels C and C′, TF32
    off) against the CPU (plain versions): the same weights, sigma, unit
    noise and dropout seed words."""
    rng = np.random.default_rng(31)
    b = 2
    sigma = torch.from_numpy(np.exp(-1.2 + 1.2 * rng.standard_normal(b)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((b, 128, 128, 3)).astype(np.float32))
    seeds = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (len(model_cpu.dropout_blocks), 2),
                                          dtype=np.int32))
    out = {}
    for where in ("cpu", dev):
        model = copy.deepcopy(model_cpu).to(where)
        st = type(stats)(*[t.to(where) for t in stats])
        hb = hr[:b].to(where)
        batch = preprocess_batch(hb, st, cfg.data.pipeline, cfg.data.lowres_scale,
                                 cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
        loss = edm_loss(model, batch["targets"], batch["inputs"], sigma=sigma, noise=noise,
                        seeds=seeds)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                                   weight_decay=cfg.train.weight_decay, device=where)
        state, met = make_edm_train_step(model, cfg)(state, hb, st, sigma=sigma, noise=noise,
                                                     seeds=seeds)
        out[str(where)] = (float(loss.detach()), [g.cpu() for g in grads], float(met["loss"]),
                           float(met["grad_norm"]), [p.detach().cpu() for p in model.parameters()])
        del model, state, grads, loss
    (lc, gc, slc, nc, pc), (lg, gg, slg, ng, pg) = out["cpu"], out[str(dev)]
    names = [n for n, _ in model_cpu.named_parameters()]
    grad_err = {n: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for n, a, b in zip(names, gg, gc)}
    worst = max(grad_err, key=grad_err.get)
    film = {n: e for n, e in grad_err.items() if "map_layer" in n}
    lr = cfg.train.lr
    step_diff = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
    flipped = float((step_diff > lr).float().mean())
    rel, step_rel = abs(lg - lc) / abs(lc), abs(slg - slc) / abs(slc)
    norm_rel = abs(ng - nc) / abs(nc)
    print(f"edm device vs cpu f32 bs={b} (TF32 off): loss cuda={lg:.7g} cpu={lc:.7g} "
          f"rel_err={rel:.3e}; grads ||dg||/||g|| max={grad_err[worst]:.3e} ({worst}), "
          f"median={float(np.median(list(grad_err.values()))):.3e}, mapping network "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in film.items()})}; train step loss "
          f"rel_err={step_rel:.3e} grad_norm cuda={ng:.7g} cpu={nc:.7g} rel_err={norm_rel:.3e}; "
          f"after AdamW max|dp|={float(step_diff.max()):.3e} (lr={lr}), share stepped the "
          f"other way (|dp|>lr): {flipped:.3e} (limits: loss {DEVICE_RTOL}, grads "
          f"{EDM_GRAD_RTOL}, share {FLIP_SHARE})")
    if not (rel <= DEVICE_RTOL and step_rel <= DEVICE_RTOL and norm_rel <= EDM_GRAD_RTOL):
        raise AssertionError(f"the EDM loss on the card differs from the CPU: {rel}, {step_rel}, "
                             f"grad norm {norm_rel}")
    if not grad_err[worst] <= EDM_GRAD_RTOL:
        raise AssertionError(f"EDM gradient of {worst} differs from the CPU: {grad_err[worst]}")
    if not flipped <= FLIP_SHARE:
        raise AssertionError(f"{flipped} of the EDM weights stepped the other way than on the "
                             f"CPU (limit {FLIP_SHARE})")


def edm_phase(dev: torch.device, hr: torch.Tensor, stats, zero_counts, read_counts) -> dict:
    """EDMPrecond at the reference baseline's widths on the flagship's data
    (``hr``, raw storage-space days on the card, and their statistics):
    the f32 loss, gradients and AdamW step on the card against the CPU;
    ``make_edm_train_step`` at bs=32 (samples/s, peak memory, 57 C and 57
    C′ launches a step); ``edm_sample`` (18 steps, 35 denoiser calls) over
    8 days and ``edm_ensemble`` with 16 members over the same days
    (member-fields/s, finite fields after ``residual_to_hr``, 35 x 57 C
    launches a sampler call); then C and C′ against their plain versions at
    every chain shape of a bs=32 training pass, on each route their plans
    have there, with random per-sample FiLM. Returns the launches of the
    training and sampler runs."""
    cfg = preset("probunet_multivar_128")
    model_cpu = _edm_model("cpu")
    n_params = sum(p.numel() for p in model_cpu.parameters())
    print(f"edm: EDMPrecond {json.dumps(EDM_WIDTHS)}, 128x128, 6 -> 3 channels, f32, "
          f"{n_params} parameters, {len(model_cpu.dropout_blocks)} blocks")
    t0 = time.perf_counter()
    edm_device_vs_cpu(model_cpu, hr.cpu(), type(stats)(*[t.cpu() for t in stats]), cfg, dev)
    print(f"edm device vs cpu: {time.perf_counter() - t0:.3f} s")
    launches = {}

    # training at bs=32 under torch's default math flags (TF32 convolutions)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    model = model_cpu.to(dev)
    state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device=dev)
    step = make_edm_train_step(model, cfg)
    batches = list(hr.split(EDM_TRAIN_BS))
    for i in range(EDM_TRAIN_WARMUP):
        state, _ = step(state, batches[i % len(batches)], stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(EDM_TRAIN_STEPS):
        state, met = step(state, batches[(EDM_TRAIN_WARMUP + i) % len(batches)], stats)
        losses.append(met["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["train"] = n = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    rate = EDM_TRAIN_STEPS * EDM_TRAIN_BS / dt
    print(f"edm train bs={EDM_TRAIN_BS} f32 (cudnn TF32 on, torch defaults): {EDM_TRAIN_STEPS} "
          f"steps in {dt:.3f} s, samples/s={rate:.2f}, step_ms={dt * 1e3 / EDM_TRAIN_STEPS:.3f}, "
          f"peak memory {peak:.3f} GB; losses {losses}; launches {json.dumps(n)}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite EDM losses {losses}")
    want = {"fused_gn": UNET_CHAINS * EDM_TRAIN_STEPS, "fused_gn_bwd": UNET_CHAINS * EDM_TRAIN_STEPS,
            "avg_pool": EDM_TRAIN_STEPS}
    if {k: v for k, v in n.items() if v} != want:
        raise AssertionError(f"EDM training launches {n}, want {want}: 57 C, 57 C′ and one G "
                             "(the batch's pooling) a step")
    hb = batches[0]
    _print_groups(f"edm breakdown train bs={EDM_TRAIN_BS}",
                  *_kernel_ms_by_group(lambda: step(state, hb, stats), 2), dt * 1e3 / EDM_TRAIN_STEPS)
    del state, step
    torch.cuda.empty_cache()

    # the sampler and the ensemble, conditioned on the standardized lrinterp
    model.eval()
    days = hr[:EDM_SAMPLE_DAYS]
    batch = preprocess_batch(days, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    cond = batch["inputs"]
    lrinterp = lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)
    shape = (EDM_SAMPLE_DAYS, 128, 128, 3)
    calls = 2 * EDM_STEPS - 1
    gen = torch.Generator(device=dev).manual_seed(41)
    edm_sample(model, shape, cond, num_steps=EDM_STEPS, generator=gen)   # warm-up
    for name, run, fields in (
            ("sample", lambda: edm_sample(model, shape, cond, num_steps=EDM_STEPS,
                                          generator=gen), EDM_SAMPLE_DAYS),
            ("ensemble", lambda: edm_ensemble(model, shape, cond, EDM_MEMBERS,
                                              num_steps=EDM_STEPS, generator=gen),
             EDM_SAMPLE_DAYS * EDM_MEMBERS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = n = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        res = out if name == "sample" else out.reshape(-1, *shape[1:])
        lri = lrinterp if name == "sample" else lrinterp.repeat_interleave(EDM_MEMBERS, 0)
        fields_hr = residual_to_hr(res, lri, stats, cfg.data.pipeline, cfg.data.epsilon,
                                   cfg.data.standardization)
        finite = int(torch.isfinite(fields_hr).flatten(1).all(1).sum())
        spread = float(out.std(dim=1).mean()) if name == "ensemble" else math.nan
        print(f"edm {name}: {tuple(out.shape)} in {dt:.3f} s ({EDM_STEPS} steps, {calls} "
              f"denoiser calls of bs={res.shape[0]}), member-fields/s={fields / dt:.2f}, peak "
              f"memory {peak:.3f} GB; {finite} of {res.shape[0]} HR fields finite; residual "
              f"mean {float(out.mean()):.5g} std {float(out.std()):.5g}"
              + (f", member spread {spread:.5g}" if name == "ensemble" else "")
              + f"; launches {json.dumps(n)}")
        if finite != res.shape[0]:
            raise AssertionError(f"edm {name}: {res.shape[0] - finite} non-finite fields")
        if {k: v for k, v in n.items() if v} != {"fused_gn": UNET_CHAINS * calls}:
            raise AssertionError(f"edm {name}: launches {n}, want {UNET_CHAINS * calls} C")
    # one denoiser call at the sampler's and the ensemble's batch
    for b in (EDM_SAMPLE_DAYS, EDM_SAMPLE_DAYS * EDM_MEMBERS):
        xb = torch.randn((b, 128, 128, 3), generator=gen, device=dev)
        cb, sb = cond.repeat(b // EDM_SAMPLE_DAYS, 1, 1, 1), torch.full((b,), 2.5, device=dev)
        with torch.no_grad():
            call_ms = _sync_ms(lambda: model(xb, sb, condition_img=cb), 3, 1, spin=False)
            _print_groups(f"edm breakdown denoiser call bs={b}",
                          *_kernel_ms_by_group(lambda: model(xb, sb, condition_img=cb), 2),
                          call_ms)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    # C and C′ at every chain shape of a bs=32 training pass, f32, random FiLM
    routes, specs = _chain_routes(model.model, torch.zeros(EDM_TRAIN_BS, 128, 128, 6,
                                                           device=dev))
    if routes != {"C": UNET_CHAINS}:
        raise AssertionError(f"EDM chains by route {routes}")
    gen = torch.Generator(device=dev).manual_seed(4325)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    # every case with FiLM (norm0 and out_norm take scale = shift = 0 in
    # the model; the kernels' general form is held here)
    cases = sorted({(nhwc, dt_name, p, silu) for _, nhwc, dt_name, _, p, silu in specs})
    print(f"edm chains: {len(cases)} (shape, dtype, p, SiLU) cases on C and C′, random "
          f"per-sample FiLM: {cases}")
    t0 = time.perf_counter()
    for nhwc, dt_name, p, silu in cases:
        _gn_vs_plain(randn, dev, nhwc, dt_name, True, p, silu, timed=False)
        torch.cuda.empty_cache()
    print(f"edm chains checked in {time.perf_counter() - t0:.3f} s")
    del model
    torch.cuda.empty_cache()
    return launches


def _packed_days(path: str, n: int) -> np.ndarray:
    hr, _, _ = load_packed(path)
    return np.ascontiguousarray(hr[:n])


def explore_phase(dev: torch.device, packed: str, ckpt: str, zero_counts, read_counts) -> dict:
    """``explore`` as users run it, through ``cli.main``, on the flagship
    checkpoint the training CLI wrote, over the packed test split: the
    default command, ``--posterior`` and ``--single`` (seconds, files
    written, the ``[timing]`` phases; every U-Net forward through 57 C
    launches), then ``collapse_diagnostics`` on the card against the CPU
    (f32, TF32 off, the same weights, contexts and draws), probe by probe.
    Returns each command's launches."""
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    launches = {}
    forwards = [0]

    def count_unets(mod, *_):
        if isinstance(mod, UNet):
            forwards[0] += 1

    base = ["explore", "--preset", CLI_PRESET, "--ckpt", ckpt, "--set",
            f"data.packed_test={packed}"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_explore_") as tmp:
        for name, flags in (("explore", []), ("explore --posterior", ["--posterior"]),
                            ("explore --single", ["--single"])):
            outdir = os.path.join(tmp, name.replace(" ", "_"))
            forwards[0] = 0
            hook = torch.nn.modules.module.register_module_forward_hook(count_unets)
            zero_counts()
            try:
                (res, spans), text, sec, rss = _run_cli(base + flags + ["--outdir", outdir])
            finally:
                hook.remove()
            launches[name] = n = read_counts()
            files = sorted(os.listdir(outdir))
            print(f"{name}: {json.dumps(res)}; host {sec:.3f} s; files {files}; timing "
                  f"{json.dumps({k: round(v, 4) for k, v in spans.items()})}; U-Net forwards "
                  f"{forwards[0]}, launches {json.dumps(n)}; peak RSS {rss:.3f} GB")
            need = ({"prior_sweep.npz"} if "single" in name
                    else {"summary.txt", "pca_artifacts.pkl", "grids.npz"})
            if not need <= set(files):
                raise AssertionError(f"{name} did not write {need - set(files)}")
            if ("figures skipped" in text) == have_mpl:
                raise AssertionError(f"{name}: figures and matplotlib disagree")
            arrays = np.load(os.path.join(outdir, "prior_sweep.npz" if "single" in name
                                          else "grids.npz"))
            bad = [k for k in arrays.files if not np.isfinite(arrays[k]).all()]
            if bad:
                raise AssertionError(f"{name}: non-finite {bad}")
            # G pools the explored days for their statistics and batches
            if not forwards[0] or {k: v for k, v in n.items() if v and k != "avg_pool"} != {
                    "fused_gn": UNET_CHAINS * forwards[0]}:
                raise AssertionError(f"{name}: launches {n} for {forwards[0]} U-Net forwards")

    # collapse_diagnostics on the card against the CPU
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = cli.build_config(argparse.Namespace(preset=CLI_PRESET, config=None, set=[]))
    hr = _packed_days(packed, EXPLORE_CHECK["max_items"])
    got = {}
    t0 = time.perf_counter()
    for where in ("cpu", dev):
        ds = ClimexDataset(hr=hr, years=range(*cfg.data.years_test),
                           variables=cfg.data.variables, coords=cfg.data.coords,
                           pipeline=cfg.data.pipeline, lowres_scale=cfg.data.lowres_scale,
                           transfo=cfg.data.transfo, interp_mode=cfg.data.interp_mode,
                           epsilon=cfg.data.epsilon, standardization=cfg.data.standardization,
                           device=where)
        model = cli._load_model(cfg, ckpt, torch.device(where))
        got[str(where)] = collapse_diagnostics(model, ds, **EXPLORE_CHECK)
        del model, ds
    print(f"explore collapse_diagnostics card and cpu: {time.perf_counter() - t0:.3f} s")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    want, card = got["cpu"], got[str(dev)]
    errs = {}
    for key, v in want.items():
        if key in ("latent_dim", "n_contexts", "collapsed"):
            if card[key] != v:
                raise AssertionError(f"collapse_diagnostics {key}: card {card[key]} cpu {v}")
        elif key in ("output_stats", "target_stats"):
            errs[f"{key}/std"] = _rel(card[key]["std"], v["std"])
            errs[f"{key}/mean"] = abs(card[key]["mean"] - v["mean"]) / v["std"]
        elif key == "ablation_mean_abs":
            errs.update({f"ablation/{k}": _rel(card[key][k], x) for k, x in v.items()})
        else:
            errs[key] = _rel(card[key], v)
    print(f"explore collapse_diagnostics card vs cpu ({json.dumps(EXPLORE_CHECK)}, f32, TF32 "
          f"off), max|err|/max|cpu| (means: /std; limit {EXPLORE_RTOL}, grad ratio {GRAD_RTOL}): "
          f"{json.dumps(errs)}; "
          f"verdict card={card['collapsed']} cpu={want['collapsed']}; summary:")
    print(format_summary(card))
    bad = {k: v for k, v in errs.items()
           if not v <= (GRAD_RTOL if k == "grad_ratio_z_over_feat" else EXPLORE_RTOL)}
    if bad:
        raise AssertionError(f"collapse_diagnostics on the card differs from the CPU: {bad}")
    return launches


def int8_trained_device_vs_cpu(dev: torch.device, packed: str, ckpt: str) -> dict:
    """The f32 int8 sample path (bs=INT8_TRAINED_DAYS, M=3) on trained
    weights, the flagship checkpoint of the training CLI's preset run, on
    the card (kernel E, TF32 off) against the CPU, over days of the packed
    test split: the same scales (calibrated on the CPU), inputs and prior
    noise. Held: max|card - cpu| at most SERVE_SHARE of the CPU's
    int8-vs-float gap, as ``infer-domain``'s. Printed either way: the first
    hooked convolution whose int8 input (its input quantized with its
    scale) differs between the two devices, with how many elements
    differ, or that none does. Returns the numbers."""
    t0 = time.perf_counter()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = cli.build_config(argparse.Namespace(preset=CLI_PRESET, config=None, set=[]))
    ds = ClimexDataset(hr=_packed_days(packed, INT8_TRAINED_DAYS),
                       years=range(*cfg.data.years_test), variables=cfg.data.variables,
                       coords=cfg.data.coords, pipeline=cfg.data.pipeline,
                       lowres_scale=cfg.data.lowres_scale, transfo=cfg.data.transfo,
                       interp_mode=cfg.data.interp_mode, epsilon=cfg.data.epsilon,
                       standardization=cfg.data.standardization, device="cpu")
    x = ds.batch(np.arange(INT8_TRAINED_DAYS))["inputs"]
    eps = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (3, INT8_TRAINED_DAYS, cfg.model.latent_dim)).astype(np.float32))
    forward = quantize.int8_forward
    inputs = ([], [])   # the CPU's, the card's: (path, int8 inputs) a convolution

    def recording(seen, paths):
        def run(mod, xin, x2=None):
            q = mod.quant_scales
            xq = [quantize.quantize_int8(xin, q["in_scale"])]
            if x2 is not None:
                xq.append(quantize.quantize_int8(x2, q["in_scale2"]))
            seen.append((paths[id(mod)], [t.cpu() for t in xq]))
            return forward(mod, xin, x2)
        return run

    out = []
    for where, seen in zip(("cpu", dev), inputs):
        model = cli._load_model(cfg, ckpt, torch.device(where))
        if not out:
            scales = quantize.calibrate_sample(model, [x], 3)
            with torch.no_grad():
                float_cpu = model.sample(x, 3, eps=eps)
        quantize.int8_forward = recording(
            seen, {id(m): p for p, m in quantize.hooked_convs(model).items()})
        try:
            with torch.no_grad(), quantize.attached(model, scales):
                out.append(model.sample(x.to(where), 3, eps=eps.to(where)).cpu())
        finally:
            quantize.int8_forward = forward
        del model
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    first = "none"
    for i, ((path, cpu_q), (_, card_q)) in enumerate(zip(*inputs)):
        n_diff = sum(int((a != b).sum()) for a, b in zip(cpu_q, card_q))
        if n_diff:
            first = (f"#{i} {path} ({n_diff} of {sum(a.numel() for a in cpu_q)} int8 input "
                     f"elements differ)")
            break
    gap = float((out[0] - float_cpu).abs().max())
    err = float((out[1] - out[0]).abs().max())
    res = {"convolutions": len(inputs[0]), "max_abs_card_minus_cpu": err,
           "cpu_int8_vs_float_gap": gap, "share": err / gap if gap else float("inf")}
    print(f"int8 trained weights device vs cpu f32 bs={INT8_TRAINED_DAYS} ({ckpt}): "
          f"{json.dumps(res)} (limit {SERVE_SHARE}); first convolution whose int8 input "
          f"differs: {first}; {time.perf_counter() - t0:.3f} s")
    if len(inputs[0]) != len(inputs[1]) or not (
            torch.isfinite(out[1]).all() and gap > 0 and err <= SERVE_SHARE * gap):
        raise AssertionError(f"int8 on trained weights, card against CPU: {res}")
    return res


def edm_and_explore_alone(dev: torch.device) -> None:
    """The ``edm`` and ``explore`` phases without the rest of the run: the
    flagship's 384 synthetic days for EDM; ``pack`` of the test split and
    one epoch of ``train`` at the preset on one year for ``explore``'s
    checkpoint. Builds the kernels first."""
    _build.build()
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = preset(CLI_PRESET)
    hr = apply_physical_transform(torch.from_numpy(synthetic_climex_fields(
        N_BATCHES * BATCH, *cfg.data.resolution, cfg.data.variables, seed=0)).to(dev),
        cfg.data.variables)
    _, zero_counts, read_counts = launch_counters()
    edm_phase(dev, hr, compute_stats(hr, cfg.data.lowres_scale), zero_counts, read_counts)
    del hr
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_explore_inputs_") as tmp:
        packed, run = os.path.join(tmp, "test.npz"), os.path.join(tmp, "train")
        _run_cli(["pack", "--preset", CLI_PRESET, "--split", "test", "--out", packed])
        _run_cli(["train", "--preset", CLI_PRESET, "--outdir", run, "--set",
                  "data.years_train=[1960,1961]", f"data.years_val={TRAIN_CLI_YEARS['val']}",
                  "train.num_epochs=1"])
        explore_phase(dev, packed, os.path.join(run, "ckpt"), zero_counts, read_counts)


def _e_yardsticks(mod, x: torch.Tensor, x2, q: dict) -> dict:
    """Two PyTorch calls the port never makes, timed at the shape of one
    hooked convolution (bf16 only): cuDNN's bf16 convolution of the same
    (concatenated) input and weight, and ``torch._int_mm`` over the
    quantized input unfolded by ``F.unfold`` (the quantization itself not
    timed; input channels zero-padded to a multiple of 8; None where
    ``_int_mm`` takes no such shape: 16 rows or fewer)."""
    w = mod.weight.detach()
    k = w.shape[-1]
    xin = x if x2 is None else torch.cat([x, x2], dim=1)
    xb = xin.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    out = {"cudnn_bf16_ms": _sync_ms(lambda: F.conv2d(xb, wb, padding=k // 2), 10)}
    n, cin, h, wd = xin.shape
    rows = n * h * wd
    if rows <= 16:
        out["int_mm_unfold_ms"] = None
        return out
    c1 = x.shape[1]
    xq = quantize.quantize_int8(x, q["in_scale"])
    if x2 is not None:
        xq = torch.cat([xq, quantize.quantize_int8(x2, q["in_scale2"])], dim=1)
    pad = (-cin) % 8
    xq = F.pad(xq.to(torch.bfloat16), (0, 0, 0, 0, 0, pad))
    qws = quantize._qweights(mod, None if x2 is None else c1)
    wq = torch.cat([qw.q for qw in qws], dim=1)
    wq = F.pad(wq, (0, 0, 0, 0, 0, pad)).reshape(wq.shape[0], -1).t().contiguous()

    def run():
        cols = F.unfold(xq, k, padding=k // 2)                  # (N, C*k*k, H*W)
        a = cols.transpose(1, 2).reshape(rows, -1).to(torch.int8)
        return torch._int_mm(a, wq)

    out["int_mm_unfold_ms"] = _sync_ms(run, 3, 1)
    return out


def e_vs_plain(model: ProbabilisticUNet, run, what: str, n_convs: int, yardsticks: bool,
               timed: dict | None = None) -> dict:
    """Kernel E against its plain version at every hooked convolution that
    ``run()`` (one int8 call of ``model``: a ``sample`` call with its scales
    attached, or an int8 eval step) takes int8, on the call's own
    activations: the int32 sums and the outputs bit for bit, a second
    launch equal to the first; there must be ``n_convs`` of them. At the
    first convolution of each distinct shape not in ``timed`` (rows of an
    earlier call) E's time, the plain version's, the bound and
    (``yardsticks``) the cuDNN bf16 and ``_int_mm`` times. Returns {shape
    key: row} of this call's shapes; the row of E_MAIN is the kernels
    line's."""
    forward = quantize.int8_forward
    paths = {id(m): p for p, m in quantize.hooked_convs(model).items()}
    timed = timed or {}
    rows = {}

    def checking(mod, xin, x2=None):
        y = forward(mod, xin, x2)
        q = mod.quant_scales
        qws = quantize._qweights(mod, None if x2 is None else xin.shape[1])
        xn = xin.permute(0, 2, 3, 1).contiguous()
        x2n = None if x2 is None else x2.permute(0, 2, 3, 1).contiguous()
        args = (xn, qws[0], q["in_scale"], mod.bias)
        kw = dict(x2=x2n, qw2=qws[1] if x2 is not None else None,
                  in_scale2=q.get("in_scale2"), out_dtype=xin.dtype)
        got, acc = int8_e.int8_conv(*args, **kw, return_acc=True)
        want, acc_p = int8_e.int8_conv_plain(*args, **kw, return_acc=True)
        path = paths[id(mod)]
        if not (torch.equal(acc, acc_p) and torch.equal(got, want)
                and torch.equal(got, y.permute(0, 2, 3, 1))):
            raise AssertionError(
                f"kernel E differs from its plain version at {path} {tuple(xn.shape)}: max "
                f"|acc diff| {int((acc.long() - acc_p.long()).abs().max())}, max |y diff| "
                f"{float((got.float() - want.float()).abs().max())}")
        n, h, w, cin = xn.shape
        cin2 = 0 if x2 is None else x2n.shape[3]
        k, cout = mod.weight.shape[-1], mod.weight.shape[0]
        key = (k, cin, cin2, cout, h, w)
        if key not in rows and key in timed:
            rows[key] = {**timed[key], "path": path, "calls": 0}
        elif key not in rows:
            macs = n * h * w * cout * (cin + cin2) * k * k
            n_bytes = (xn.numel() + (0 if x2 is None else x2n.numel())) * xn.element_size() \
                + got.numel() * got.element_size() + sum(qw.words.numel() * 4 for qw in qws)
            row = {"path": path, "calls": 0, "plan": _e_plan_text(key, n, xn.dtype),
                   "ms": _sync_ms(lambda: int8_e.int8_conv(*args, **kw), 10),
                   "plain_ms": _sync_ms(lambda: int8_e.int8_conv_plain(*args, **kw), 2, 1),
                   **_bound(n_bytes, 2.0 * macs, "int8")}
            if yardsticks:
                row.update(_e_yardsticks(mod, xin, x2, q))
            rows[key] = row
        rows[key]["calls"] += 1
        return y

    quantize.int8_forward = checking
    try:
        with torch.no_grad():
            run()
    finally:
        quantize.int8_forward = forward
    torch.cuda.synchronize()
    for key, r in rows.items():
        k, cin, cin2, cout, h, w = key
        extra = "".join(f" {name}={r[name]:.4f}" if r[name] is not None else f" {name}=None"
                        for name in ("cudnn_bf16_ms", "int_mm_unfold_ms") if name in r)
        print(f"kernel int8_conv {what} {h}x{w}x{cin}{f'+{cin2}' if cin2 else ''}->{cout} "
              f"k={k} ({r['path']}, {r['calls']} calls): bits exact; "
              + ("timed above" if key in timed else
                 f"E_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                 f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}){extra}; {r['plan']}"))
    n_calls = sum(r["calls"] for r in rows.values())
    if n_calls != n_convs:
        raise AssertionError(f"{n_calls} hooked convolutions ran int8 in one {what} call, "
                             f"not {n_convs}")
    sums = {name: sum(r[name] * r["calls"] for r in rows.values())
            for name in ("ms", "bound_ms", "cudnn_bf16_ms")
            if all(r.get(name) is not None for r in rows.values())}
    print(f"kernel int8_conv {what}: E equal to its plain version bit for bit (int32 sums and "
          f"outputs) at {n_calls} convolutions, {len(rows)} distinct shapes, "
          f"{len(set(rows) - set(timed))} new; summed over the {n_calls} at their shapes (ms): "
          f"{json.dumps({k: round(v, 4) for k, v in sums.items()})}")
    return rows


def _e_tree_counts(scales: dict) -> tuple[int, int]:
    """(leaves, in_scale2 leaves) of a scales tree."""
    n = len(quantize.tree_leaves(scales))
    return n, n - len(quantize.tree_leaves(quantize.quant_skip(scales, ["in_scale2$"])))


def int8_device_vs_cpu(model32: ProbabilisticUNet, hr: torch.Tensor, stats, cfg,
                       dev: torch.device) -> None:
    """The f32 int8 serve path (bs=2) on the card (kernel E, TF32 off)
    against the CPU (plain version), with the same scales (calibrated on
    the CPU) and prior noise:

    - held: every hooked convolution of the CPU's int8 sample call, fed the
      CPU's own inputs on the card, gives the CPU's output bit for bit;
    - printed: the two devices' end-to-end results, beside the CPU's own
      change when its float path alone changes in the last bits (the
      composed GroupNorm route): a float value within those bits of a
      rounding boundary quantizes to the neighbouring int8 value, and
      through the flagship's 87 quantized convolutions such flips cascade
      to a large share of the int8-vs-float gap at random weights (0.66 on
      the card's host CPU between its two GroupNorm routes, the share this
      function prints), so no end-to-end bound is held here.

    Then E against its plain version at every hooked convolution of a
    bs=16 f32 sample call on the card."""
    t0 = time.perf_counter()
    eps = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (3, 2, cfg.model.latent_dim)).astype(np.float32))

    def inputs(where, n):
        st = type(stats)(*[s.to(where) for s in stats])
        return preprocess_batch(hr[:n].to(where), st, cfg.data.pipeline, cfg.data.lowres_scale,
                                cfg.data.interp_mode, cfg.data.epsilon,
                                cfg.data.standardization)["inputs"]

    model32.to("cpu")
    composed = _variant(model32, cfg, gn_impl="composed")
    x = inputs("cpu", 2)
    scales = quantize.calibrate_sample(model32, [x], 3)
    forward = quantize.int8_forward
    records = []

    def recording(mod, xin, x2=None):
        y = forward(mod, xin, x2)
        records.append((mod, xin.clone(), None if x2 is None else x2.clone(), y.clone()))
        return y

    with torch.no_grad():
        float_cpu = model32.sample(x, 3, eps=eps)
        with quantize.attached(composed, scales):
            int8_composed = composed.sample(x, 3, eps=eps)
        with quantize.attached(model32, scales):
            quantize.int8_forward = recording
            try:
                int8_cpu = model32.sample(x, 3, eps=eps)
            finally:
                quantize.int8_forward = forward
    del composed
    model32.to(dev)
    with torch.no_grad(), quantize.attached(model32, scales):
        int8_card = model32.sample(inputs(dev, 2), 3, eps=eps.to(dev)).cpu()
        paths = {id(m): p for p, m in quantize.hooked_convs(model32).items()}
        for mod, xin, x2, y in records:
            got = forward(mod, xin.to(dev), None if x2 is None else x2.to(dev)).cpu()
            if not torch.equal(got, y):
                raise AssertionError(f"int8 convolution {paths[id(mod)]} on the card differs "
                                     f"from the CPU on the CPU's inputs: max |diff| "
                                     f"{float((got - y).abs().max())}")
    gap = float((int8_cpu - float_cpu).abs().max())
    err = float((int8_card - int8_cpu).abs().max())
    own = float((int8_composed - int8_cpu).abs().max())
    print(f"int8 device vs cpu f32 bs=2: {len(records)} convolutions fed the CPU's inputs equal "
          f"the CPU's outputs bit for bit; end to end max|card - cpu|={err:.6g}, the CPU's own "
          f"change under the composed GroupNorm route {own:.6g}, cpu int8-vs-float gap "
          f"{gap:.6g} (shares {err / gap:.4g} and {own / gap:.4g}; printed, not held)")
    if len(records) != INT8_SAMPLE_LEAVES - INT8_SAMPLE_SPLIT or not bool(
            torch.isfinite(int8_card).all()):
        raise AssertionError(f"{len(records)} int8 convolutions, or non-finite card results")
    x16 = inputs(dev, 16)
    eps16 = eps[:, :1].expand(3, 16, -1).contiguous().to(dev)
    with quantize.attached(model32, quantize.calibrate_sample(model32, [x16], 3)):
        e_vs_plain(model32, lambda: model32.sample(x16, 3, eps=eps16), "float32 bs=16 sample",
                   INT8_SAMPLE_LEAVES - INT8_SAMPLE_SPLIT, yardsticks=False)
    model32.to("cpu")
    torch.cuda.empty_cache()
    print(f"int8 device vs cpu and f32 E checks: {time.perf_counter() - t0:.3f} s")


def int8_phase(model: ProbabilisticUNet, batches: list[torch.Tensor], stats, cfg,
               dev: torch.device, zero_counts, read_counts) -> tuple[dict, dict]:
    """int8 serving of the flagship (bf16, random weights): calibration on
    INT8_CALIB_BATCHES batches of other synthetic days, kernel E against its
    plain version at every hooked convolution of a bs=128 sample call with
    its times and yardsticks, the prior ensemble (M=16) float against int8
    (member-fields/s; 87 E and 57 C launches a call, 85 E with the heads
    kept in float), E's share of a call's device time, and the eval ELBO
    (M=5) calibrated by ``calibrate_elbo``, float against int8, with E held
    against its plain version at every convolution of one int8 eval step
    (the posterior's included); E's launches by route are held too. Returns
    (the kernels-line rows of E's two routes, the launches of the int8 serve
    runs)."""
    t0 = time.perf_counter()
    days = INT8_CALIB_BATCHES * BATCH
    hr_cal = apply_physical_transform(torch.from_numpy(synthetic_climex_fields(
        days, *cfg.data.resolution, cfg.data.variables, seed=1)).to(dev), cfg.data.variables)

    def prep(h):
        return preprocess_batch(h, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                                cfg.data.interp_mode, cfg.data.epsilon,
                                cfg.data.standardization)["inputs"]

    cal = list(hr_cal.split(BATCH))
    t1 = time.perf_counter()
    scales = quantize.calibrate_sample(model, [prep(h) for h in cal], ENSEMBLE_M)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t1
    heads = quantize.quant_skip(scales, ["heads"])
    counts = (_e_tree_counts(scales), _e_tree_counts(heads))
    print(f"int8 calibrate_sample: {counts[0][0]} scales ({counts[0][1]} in_scale2) on "
          f"{len(cal)} batches of {BATCH} in {calib_s:.3f} s; --quant-skip heads leaves "
          f"{counts[1][0]}")
    if counts != ((INT8_SAMPLE_LEAVES, INT8_SAMPLE_SPLIT),
                  (INT8_SAMPLE_LEAVES - INT8_HEADS, INT8_SAMPLE_SPLIT)):
        raise AssertionError(f"scales trees of {counts}")

    eps = torch.randn((ENSEMBLE_M, BATCH, cfg.model.latent_dim),
                      generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    xs = [prep(h) for h in batches]
    with quantize.attached(model, scales):
        rows = e_vs_plain(model, lambda: model.sample(xs[0], ENSEMBLE_M, eps=eps),
                          f"bfloat16 bs={BATCH} sample", INT8_SAMPLE_LEAVES - INT8_SAMPLE_SPLIT,
                          yardsticks=True)
    main = rows[E_MAIN]

    res, launches, outs = {}, {}, {}
    e_calls = INT8_SAMPLE_LEAVES - INT8_SAMPLE_SPLIT
    for name, tree, per_call in (("float", None, 0), ("int8", scales, e_calls),
                                 ("int8 heads float", heads, e_calls - INT8_HEADS)):
        with quantize.attached(model, tree), torch.no_grad():
            model.sample(xs[0], ENSEMBLE_M, eps=eps)                    # warm-up
            zero_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs[name] = [model.sample(x, ENSEMBLE_M, eps=eps) for x in xs]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launches[f"sample {name}"] = n = read_counts()
            if tree is not None:
                _print_groups(f"int8 breakdown sample {name}",
                              *_kernel_ms_by_group(lambda: model.sample(xs[0], ENSEMBLE_M,
                                                                        eps=eps), 2),
                              dt * 1e3 / len(xs))
        res[f"sample_{name.replace(' ', '_')}_member_fields_per_s"] = \
            len(xs) * BATCH * ENSEMBLE_M / dt
        print(f"int8 prior ensemble {name}: M={ENSEMBLE_M} bs={BATCH} {len(xs)} calls, "
              f"{dt * 1e3 / len(xs):.3f} ms a call, member-fields/s="
              f"{len(xs) * BATCH * ENSEMBLE_M / dt:.2f}; E launches {n['int8_conv']}, C "
              f"{n['fused_gn']}")
        first = E_MMA_SYNC_SAMPLE * len(xs) if tree is not None else 0
        if n["int8_conv"] != per_call * len(xs) or n["fused_gn"] != UNET_CHAINS * len(xs) or \
                n["int8_conv_mma_sync"] != first or \
                n["int8_conv_wgmma"] != per_call * len(xs) - first:
            raise AssertionError(f"{name}: {n['int8_conv']} E ({n['int8_conv_wgmma']} wgmma, "
                                 f"{n['int8_conv_mma_sync']} mma_sync) and {n['fused_gn']} C "
                                 f"launches for {len(xs)} sample calls")
        if not all(bool(torch.isfinite(o).all()) for o in outs[name]):
            raise AssertionError(f"{name}: non-finite ensemble members")
    for name in ("int8", "int8 heads float"):
        d = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for a, b in zip(outs[name], outs["float"]))
        print(f"int8 prior ensemble {name} vs float: max |diff| / max |float| = {d:.4g}")

    # the eval ELBO (M=5), calibrated on its own path (posterior included)
    t1 = time.perf_counter()
    elbo_scales = quantize.calibrate_elbo(model, cal, cfg, stats)
    leaves = _e_tree_counts(elbo_scales)
    steps = {"float": make_eval_step(model, cfg), "int8": make_eval_step(model, cfg,
                                                                          quant=elbo_scales)}
    # every convolution of one int8 eval step (the posterior's 128x128x6 -> 32
    # first convolution included) bit for bit against the plain version
    e_vs_plain(model, lambda: steps["int8"](batches[0], stats,
                                            torch.Generator(device=dev).manual_seed(100)),
               f"bfloat16 bs={BATCH} eval ELBO", leaves[0] - leaves[1], yardsticks=True,
               timed=rows)
    recon = {}
    for name, step in steps.items():
        step(batches[0], stats, torch.Generator(device=dev).manual_seed(100))
        zero_counts()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ms = [step(hr, stats, torch.Generator(device=dev).manual_seed(100 + i))
              for i, hr in enumerate(batches)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t2
        launches[f"eval {name}"] = n = read_counts()
        recon[name] = [float(m["recon"]) for m in ms]
        res[f"eval_{name}_samples_per_s"] = len(batches) * BATCH / dt
        print(f"int8 eval ELBO {name}: recon {recon[name]}, samples/s="
              f"{len(batches) * BATCH / dt:.2f}; E launches {n['int8_conv']}")
        if not all(math.isfinite(v) for m in ms for v in map(float, m.values())):
            raise AssertionError(f"eval {name}: non-finite metrics")
        want = (leaves[0] - leaves[1]) * len(batches) if name == "int8" else 0
        first = E_MMA_SYNC_EVAL * len(batches) if name == "int8" else 0
        if n["int8_conv"] != want or n["int8_conv_mma_sync"] != first or \
                n["int8_conv_wgmma"] != want - first:
            raise AssertionError(f"eval {name}: {n['int8_conv']} E launches ("
                                 f"{n['int8_conv_mma_sync']} mma_sync), not {want} ({first})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(recon["int8"], recon["float"]))
    print(f"int8 calibrate_elbo: {leaves[0]} scales ({leaves[1]} in_scale2), "
          f"{leaves[0] - leaves[1]} E launches a step; eval recon int8 vs float max rel "
          f"{rel:.4g}; eval part {time.perf_counter() - t1:.3f} s")
    print(f"int8 rates: {json.dumps(res)}; int8 phase {time.perf_counter() - t0:.3f} s")
    e_rows = {name: {"max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["cudnn_bf16_ms"], "int_mm_unfold_ms": r["int_mm_unfold_ms"]}
              for name, r in (("int8_conv", main), ("int8_conv_mma_sync", rows[E_MMA_SYNC_MAIN]))}
    del hr_cal, cal, xs, outs
    torch.cuda.empty_cache()
    return e_rows, launches


@contextlib.contextmanager
def _bench_env(env: dict):
    """The bench knobs (BENCH_ENV) set to ``env`` alone, and PyTorch's default
    TF32 settings as a user's run gets them, for the block."""
    saved = {k: os.environ.get(k) for k in BENCH_ENV}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        for k in BENCH_ENV:
            os.environ.pop(k, None)
        os.environ.update(env)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _bench_run(label: str, env: dict, kernels, zero_counts, read_counts) -> tuple[dict, dict]:
    """``python -m probunet_tpu_torch bench`` (``cli.main(["bench"])``) under
    ``env``: its JSON line printed whole, its rate, FLOP count, peak memory
    and power limit finite and positive, its MFU share at most MFU_LIMIT,
    and ``kernels`` launched (the counts set to 0 just before). Returns
    (the line, the launches)."""
    with _bench_env(env):
        zero_counts()
        res, _, seconds, _ = _run_cli(["bench"])
        n = read_counts()
    print(f"bench {label}: {json.dumps(res)}")
    print(f"bench {label}: {seconds:.3f} s; launches {json.dumps(n)}")
    flops = res.get("flops_per_step", res.get("flops_per_batch"))
    numbers = (res["value"], flops, res["peak_memory_gb"],
               res["device"]["power_limit_w"], res["mfu_vs_h100_bf16_dense_peak"])
    if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in numbers):
        raise AssertionError(f"bench {label}: a number is not finite and positive")
    if res["metric"].endswith("_cpu_smoke") or not res["device"]["name"]:
        raise AssertionError(f"bench {label}: not a card run")
    mfu = {k: v for k, v in res.items() if k.startswith("mfu")}
    if not all(v <= MFU_LIMIT for v in mfu.values()):
        raise AssertionError(f"bench {label}: MFU {mfu} above {MFU_LIMIT}")
    idle = [k for k in kernels if n[k] <= 0]
    if idle:
        raise AssertionError(f"bench {label}: kernels {idle} were not launched")
    return res, n


def bench_phase(zero_counts, read_counts) -> dict:
    """``python -m probunet_tpu_torch bench`` once per mode of BENCH_MODES at
    its defaults (flagship, bf16, bs=128) through :func:`_bench_run`.
    Returns the launches by mode."""
    launches = {}
    for mode, env, kernels in BENCH_MODES:
        label = " ".join([mode, *env.values()])
        _, launches[f"bench {label}"] = _bench_run(label, {"BENCH_MODE": mode, **env}, kernels,
                                                   zero_counts, read_counts)
    return launches


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts one element past its storage's
    (aligned) start, so that the wrappers take the 1-element instances."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _act8_vs_plain(gen, shape, dtype: str, misaligned: bool) -> dict:
    """Kernels F and F′ against their plain versions at one NHWC shape: q, s
    and xh bit for bit (per-channel scales over four decades, a channel of
    zeros and one of exact ties, absmax 127 / 8 so that every x / s is k +
    1/2), then F's time (both launches), F′'s, the plain versions' and the
    bounds. ``misaligned``: x and F′'s q are views one element past
    alignment. Fails unless the instance the wrappers pick is the one the
    case is for (8 elements a thread only where C % 8 == 0 and aligned).
    Returns their JSON rows."""
    dev = gen.device
    tdt = getattr(torch, dtype)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev) * torch.logspace(-2, 2, c, device=dev)
    x[..., 0] = 0.0
    ties = torch.randint(-127, 127, shape[:-1], generator=gen, device=dev) + 0.5
    x[..., 1] = ties / 8
    x.view(-1, c)[0, 1] = 127 / 8
    x = x.to(tdt)
    if misaligned:
        x = _misaligned(x)
    want_vec = int(c % 8 == 0 and not misaligned)
    with torch.no_grad():
        q, s = act_compress.quantize_channels(x)
        if misaligned:
            q = _misaligned(q)
        xh = act_compress.dequantize(q, s, tdt)
        vec = {"F": act_compress._vec(c, x), "F'": act_compress._vec(c, q, xh)}
        if vec != {"F": want_vec, "F'": want_vec}:
            raise AssertionError(f"act_compress at {shape} {dtype} misaligned={misaligned}: "
                                 f"the wrappers picked {vec}, the case is for {want_vec}")
        s0 = act_compress.scales_plain(act_compress.absmax_plain(x))
        q0 = act_compress.quantize_plain(x, s0)
        xh0 = act_compress.dequantize_plain(q0, s0, tdt)
        exact = {"q": torch.equal(q, q0), "s": torch.equal(s, s0), "xh": torch.equal(xh, xh0)}
        f_ms = _sync_ms(lambda: act_compress.quantize_channels(x), 20)
        f_plain_ms = _sync_ms(lambda: act_compress.quantize_plain(
            x, act_compress.scales_plain(act_compress.absmax_plain(x))), 3, 1)
        fp_ms = _sync_ms(lambda: act_compress.dequantize(q, s, tdt), 20)
        fp_plain_ms = _sync_ms(lambda: act_compress.dequantize_plain(q, s, tdt), 3, 1)
    n, e = x.numel(), x.element_size()
    # F reads x twice and writes q (|x|, the max, a division and a rounding
    # an element); F′ reads q and writes xh (one product an element)
    rows = {"act_compress_quantize": {
                "max_abs_err": float((q.int() - q0.int()).abs().max()), "ms": f_ms,
                "plain_ms": f_plain_ms, **_bound(n * (2 * e + 1), 4.0 * n, "float32"),
                "library_ms": None, "shape": list(shape), "dtype": dtype},
            "act_compress_dequantize": {
                "max_abs_err": float((xh.float() - xh0.float()).abs().max()), "ms": fp_ms,
                "plain_ms": fp_plain_ms, **_bound(n * (1 + e), 1.0 * n, "float32"),
                "library_ms": None, "shape": list(shape), "dtype": dtype}}
    print(f"kernel act_compress   shape={shape} {dtype} misaligned={misaligned} "
          f"elements_a_thread={8 if want_vec else 1} exact={json.dumps(exact)} "
          f"ties_even={bool((q[..., 1].flatten()[1:] % 2 == 0).all())} F_ms={f_ms:.4f} "
          f"F_plain_ms={f_plain_ms:.4f} "
          f"F_bound_ms={rows['act_compress_quantize']['bound_ms']:.4f} "
          f"F'_ms={fp_ms:.4f} F'_plain_ms={fp_plain_ms:.4f} "
          f"F'_bound_ms={rows['act_compress_dequantize']['bound_ms']:.4f}")
    if not all(exact.values()):
        raise AssertionError(f"act_compress kernels differ from their plain versions at "
                             f"{shape} {dtype} misaligned={misaligned}: {exact}")
    return rows


def _act8_data(cfg, days: int, dev):
    hr = apply_physical_transform(torch.from_numpy(synthetic_climex_fields(
        days, *cfg.data.resolution, cfg.data.variables, seed=5)).to(dev), cfg.data.variables)
    return hr, compute_stats(hr, cfg.data.lowres_scale)


def _act8_steps(dev, zero_counts, read_counts) -> dict:
    """The flagship bf16 model with compression on the card: the eval step
    launches no F or F′; one train step launches each once a convolution
    input (a split convolution's two inputs apart); the bytes the step saves
    for the backward with compression off and on at bs=128. Returns the
    launches."""
    cfg = preset("probunet_multivar_128")
    cfg.model.compute_dtype = "bfloat16"
    cfg.train.ensemble_size = TRAIN_M
    hr, stats = _act8_data(cfg, BATCH, dev)
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device=dev,
                                          act_compress=True)
    zero_counts()
    make_eval_step(model, cfg)(hr[:ACT8_STEP_BS], stats,
                               torch.Generator(device=dev).manual_seed(0))
    launches = {"act8 eval step": read_counts()}
    inputs = []
    hooks = [m.register_forward_hook(lambda mod, a, out: inputs.append(len(a)))
             for m in model.unet.modules() if getattr(m, "act_compress", False) and m.kernel]
    state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr, device=dev)
    zero_counts()
    make_train_step(model, cfg)(state, hr[:ACT8_STEP_BS], stats, 1.0, 1.0)
    launches["act8 train step"] = n = read_counts()
    for h in hooks:
        h.remove()
    want = sum(inputs)
    print(f"act_compress steps bs={ACT8_STEP_BS}: eval step launches "
          f"{json.dumps({k: launches['act8 eval step'][k] for k in ACT8_KERNELS})}; train "
          f"step {json.dumps({k: n[k] for k in ACT8_KERNELS})} for {len(inputs)} convolution "
          f"calls with {want} inputs")
    if any(launches["act8 eval step"][k] for k in ACT8_KERNELS):
        raise AssertionError("the eval step launched F or F′")
    if not n["act_compress_quantize"] == n["act_compress_dequantize"] == want > 0:
        raise AssertionError(f"the compressed train step launched F/F′ {n} times for {want} "
                             "convolution inputs")
    del state
    saved = {"act_compress": elbo_saved_bytes(model, cfg, hr, stats)}
    torch.cuda.empty_cache()
    plain = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device=dev)
    saved["float"] = elbo_saved_bytes(plain, cfg, hr, stats)
    print(f"act_compress saved for backward (bs={BATCH} bf16, the training ELBO, distinct "
          f"storages, parameters left out): {json.dumps(saved)}; ratio "
          f"{saved['act_compress']['bytes'] / saved['float']['bytes']:.4f}")
    del model, plain
    torch.cuda.empty_cache()
    return launches


def act_compress_phase(dev, zero_counts, read_counts) -> tuple[dict, dict]:
    """Int8 saved convolution inputs (PROBUNET_ACT_COMPRESS=int8, kernels F
    and F′): ``bench`` train with compression off and on at each of
    ACT8_BENCH_BS first, while nothing else of the phase holds device
    memory (samples/s and peak memory; a batch that does not fit fails the
    phase); each kernel bit for bit against its plain version at
    ACT8_CASES; the f32 compressed training step on the card against the
    CPU (TF32 off); the eval and train steps' launches and the saved bytes
    (:func:`_act8_steps`). Returns (the kernels' JSON rows, the launches by
    run)."""
    t0 = time.perf_counter()
    launches, rates = {}, {}
    print(f"act_compress: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated before "
          "the bench runs")
    for bs in ACT8_BENCH_BS:
        for on in (False, True):
            label = f"train act_compress={'int8' if on else 'off'} bs={bs}"
            env = {"BENCH_MODE": "train", "BENCH_BS": str(bs),
                   **({"PROBUNET_ACT_COMPRESS": "int8"} if on else {})}
            kernels = BENCH_TRAIN_KERNELS + (ACT8_KERNELS if on else ())
            res, n = _bench_run(label, env, kernels, zero_counts, read_counts)
            if not on and any(n[k] for k in ACT8_KERNELS):
                raise AssertionError(f"bench {label}: F or F′ launched with compression off")
            launches[f"bench {label}"] = n
            rates[label] = {"samples_per_s": res["value"],
                            "peak_memory_gb": res["peak_memory_gb"]}
            torch.cuda.empty_cache()
    print(f"act_compress rates: {json.dumps(rates)}")
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = {}
    for shape, dtype, misaligned in ACT8_CASES:
        got = _act8_vs_plain(gen, shape, dtype, misaligned)
        rows = rows or got
        torch.cuda.empty_cache()
    cfg32 = preset("probunet_multivar_128")
    model32 = ProbabilisticUNet.from_config(cfg32, torch.Generator().manual_seed(0),
                                            device="cpu", act_compress=True)
    _fill_zero_params(model32, torch.Generator().manual_seed(1))
    hr, stats = _act8_data(cfg32, 8, "cpu")
    train_device_vs_cpu(model32, hr, stats, cfg32, dev, routes=(True,), sensitivity=False,
                        what="act_compress")
    del model32
    launches.update(_act8_steps(dev, zero_counts, read_counts))
    print(f"act_compress phase {time.perf_counter() - t0:.3f} s")
    return rows, launches


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _flagship_model(cfg, dtype_cfg=None) -> ProbabilisticUNet:
    """The flagship at full width from a seed, zero-initialized parameters
    filled (``_fill_zero_params``), on the CPU."""
    gen = torch.Generator().manual_seed(0)
    model = ProbabilisticUNet.from_config(dtype_cfg or cfg, gen, device="cpu")
    _fill_zero_params(model, gen)
    return model


def _par_days(n: int, cfg, dev, seed: int) -> torch.Tensor:
    phys = synthetic_climex_fields(n, *cfg.data.resolution, cfg.data.variables, seed=seed)
    return apply_physical_transform(torch.from_numpy(phys).to(dev), cfg.data.variables)


def _step_rates(steps: dict, state_of: dict, hr, stats, timed_order) -> dict:
    """samples/s of each named step over PAR_STEPS synchronized steps after
    PAR_WARMUP, timed in ``timed_order`` (a name may come twice: the
    rates are averaged)."""
    times = collections.defaultdict(list)
    for name in timed_order:
        for i in range(PAR_WARMUP + PAR_STEPS):
            if i == PAR_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state_of[name], _ = steps[name](state_of[name], hr, stats, 1.0, 1.0)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    return {k: PAR_STEPS * hr.shape[0] / (sum(v) / len(v)) for k, v in times.items()}


def _two_blocks(call):
    """``call(i, reduce)`` on blocks 0 and 1 of an image's rows, each
    block's partial sums summed with the other's in place as the ranks'
    all-reduce sums them (block 1's partials taken by a first call whose
    outputs are dropped); returns the two blocks' results."""
    saved = {}
    call(1, lambda t: saved.__setitem__(1, t.clone()))

    def first(t):
        saved[0] = t.clone()
        t.add_(saved[1])

    return call(0, first), call(1, lambda t: t.add_(saved[0]))


def _split_chain_vs_plain(randn, dev, shape, groups: int, timed: bool) -> dict:
    """Split C and C′ on the two half-height blocks of a (B, H, W, C) bf16
    chain (FiLM, p = 0.1), each under the seed words shifted to its first
    element and its partial sums summed with the other block's, against
    the split plain versions on the same blocks: y and dx within GN_TOL,
    the statistics and parameter terms within GN_SUM_TOL, the masks those
    of the global elements bit for bit, each kernel run twice for identical
    bits. With ``timed``: split C and C′ on one block (their two launches;
    the sum between them is the ranks' all-reduce, not timed here) beside
    the unsplit planned route on the same block shape, the split plain
    versions and the block's bound."""
    b, hh, w, c = shape
    h = hh // 2
    x, g = (randn(*shape) + 0.5).to(torch.bfloat16), randn(*shape).to(torch.bfloat16)
    gamma, beta = 1 + randn(c, scale=0.1), randn(c, scale=0.1)
    scale, shift = randn(b, c, scale=0.2), randn(b, c, scale=0.2)
    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    blocks = [(x[:, i * h:(i + 1) * h].contiguous(), g[:, i * h:(i + 1) * h].contiguous(),
               fused_gn.slab_seed(seed, 0, i * h * w * c)) for i in (0, 1)]
    consts = (groups, 1e-5, 0.1, True)

    def fwd(fn, plain=False):   # the plain version also takes the block's first row
        return _two_blocks(lambda i, red: fn(blocks[i][0], gamma, beta, scale, shift,
                                             blocks[i][2], *consts, hh, red,
                                             *([i * h] if plain else [])))

    got, again = fwd(fused_gn._launch_split_fwd), fwd(fused_gn._launch_split_fwd)
    want = fwd(fused_gn.gn_split_fwd_plain, plain=True)
    whole_keep = fused_gn.gn_keep(shape, seed, 0.1)
    err = {"y": 0.0, "mean": 0.0, "rstd": 0.0, "dx": 0.0, "dgamma": 0.0, "dbeta": 0.0,
           "dscale": 0.0, "dshift": 0.0}
    masks, abs_err, bwd_abs_err = True, 0.0, 0.0
    for i, (gi, ai, wi) in enumerate(zip(got, again, want)):
        if not all(torch.equal(u, v) for u, v in zip(gi, ai)):
            raise AssertionError(f"split C is not bit-reproducible at {shape}")
        for k, u, v in zip(("y", "mean", "rstd"), gi, wi):
            err[k] = max(err[k], _max_err_ratio(u.float(), v.float()))
        abs_err = max(abs_err, float((gi[0].float() - wi[0].float()).abs().max()))
        keep = fused_gn.gn_keep(blocks[i][0].shape, blocks[i][2], 0.1)
        kept_zeros = int(((gi[0] == 0) & keep).sum())
        masks &= (torch.equal(keep, whole_keep[:, i * h:(i + 1) * h])
                  and bool((gi[0][~keep] == 0).all()) and kept_zeros <= 1e-6 * keep.numel())

    def bwd(fn, plain=False):
        return _two_blocks(lambda i, red: fn(blocks[i][0], blocks[i][1], gamma, beta, scale,
                                             shift, blocks[i][2], got[i][1], got[i][2],
                                             groups, 0.1, True, hh, red,
                                             *([i * h] if plain else [])))

    gb, gb2, wb = (bwd(fused_gn._launch_split_bwd), bwd(fused_gn._launch_split_bwd),
                   bwd(fused_gn.gn_split_bwd_plain, plain=True))
    for u, v in zip(gb, gb2):
        if not all(torch.equal(p, q) for p, q in zip(u, v)):
            raise AssertionError(f"split C′ is not bit-reproducible at {shape}")
    for i in (0, 1):
        err["dx"] = max(err["dx"], _max_err_ratio(gb[i][0].float(), wb[i][0].float()))
        bwd_abs_err = max(bwd_abs_err, float((gb[i][0].float() - wb[i][0].float()).abs().max()))
    for j, k in enumerate(("dgamma", "dbeta", "dscale", "dshift"), start=1):
        err[k] = _max_err_ratio(gb[0][j] + gb[1][j], wb[0][j] + wb[1][j])
    bad = {k: e for k, e in err.items()
           if not e <= (GN_TOL["bfloat16"] if k in ("y", "dx") else GN_SUM_TOL)}
    if not masks:
        bad["masks"] = "differ"
    line = (f"spatial split C/C′ shape={shape} blocks of {h} rows groups={groups} bf16 p=0.1 "
            f"bit_reproducible=True masks_equal={masks} max_err/max={json.dumps(err)}")
    row = {}
    if timed:
        x0, g0, s0 = blocks[0]
        y0, mean0, rstd0 = got[0]
        args = (gamma, beta, scale, shift, s0, *consts)
        noop = lambda t: None   # noqa: E731  (the ranks' all-reduce, not timed)
        ms = {"split C": _sync_ms(lambda: fused_gn._launch_split_fwd(x0, *args, hh, noop), 20),
              "unsplit C": _sync_ms(lambda: fused_gn._launch(x0, *args), 20),
              "split C plain": _sync_ms(
                  lambda: fused_gn.gn_split_fwd_plain(x0, *args, hh, noop, 0), 2, 1)}
        bargs = (x0, g0, gamma, beta, scale, shift, s0, mean0, rstd0, groups, 0.1, True)
        ms.update({"split C′": _sync_ms(lambda: fused_gn._launch_split_bwd(*bargs, hh, noop), 20),
                   "unsplit C′": _sync_ms(lambda: fused_gn._launch_bwd(*bargs), 20),
                   "split C′ plain": _sync_ms(
                       lambda: fused_gn.gn_split_bwd_plain(*bargs, hh, noop, 0), 2, 1)})
        m = x0.numel()
        vec = 4.0 * (2 * c + 2 * b * c + 2 * b * groups)
        fb = _bound(2.0 * 2 * m + vec, 26.0 * m, "float32")
        bb = _bound(3.0 * 2 * m + vec + 4.0 * 2 * b * c, 46.0 * m, "float32")
        line += (f" block={tuple(x0.shape)} ms={json.dumps(ms)} bound_ms C "
                 f"{fb['bound_ms']:.4f} C′ {bb['bound_ms']:.4f}")
        row = {"fused_gn": {"split_ms": ms["split C"], "split_plain_ms": ms["split C plain"],
                            "unsplit_ms_at_block": ms["unsplit C"],
                            "split_bound_ms": fb["bound_ms"], "split_max_abs_err": abs_err,
                            "split_block": list(x0.shape)},
               "fused_gn_bwd": {"split_ms": ms["split C′"],
                                "split_plain_ms": ms["split C′ plain"],
                                "unsplit_ms_at_block": ms["unsplit C′"],
                                "split_bound_ms": bb["bound_ms"],
                                "split_max_abs_err": bwd_abs_err,
                                "split_block": list(x0.shape)}}
    print(line)
    if bad:
        raise AssertionError(f"split C/C′ disagree with their plain versions at {shape}: {bad}")
    return row


def _mapped_dropout_vs_plain(randn, dev, shape) -> dict:
    """Kernel D on the two half-height blocks of a (B, H, W, C) bf16 tensor,
    told each block's first element and the global per-item size: the
    whole tensor's D output rows bit for bit, and the mapped plain version
    bit for bit; timed on a block beside D without the mapping on the same
    block shape, the mapped plain version and the block's bound."""
    b, hh, w, c = shape
    h, item = hh // 2, hh * w * c
    x = randn(*shape).to(torch.bfloat16)
    seed = torch.tensor([20250101, -7], dtype=torch.int32, device=dev)
    whole = dropout._launch(x, seed, 0.1)
    exact = {}
    for i in (0, 1):
        xb = x[:, i * h:(i + 1) * h].contiguous()
        at = i * h * w * c
        got = dropout._launch(xb, seed, 0.1, at, x.numel(), item)
        exact[f"block {i} = whole rows"] = torch.equal(got, whole[:, i * h:(i + 1) * h])
        exact[f"block {i} = plain"] = torch.equal(
            got, dropout.dropout_plain(xb, seed, 0.1, at, x.numel(), item))
    xb = x[:, h:].contiguous()
    ms = {"mapped": _sync_ms(lambda: dropout._launch(xb, seed, 0.1, h * w * c, x.numel(), item),
                             20),
          "unmapped": _sync_ms(lambda: dropout._launch(xb, seed, 0.1), 20),
          "mapped plain": _sync_ms(lambda: dropout.dropout_plain(
              xb, seed, 0.1, h * w * c, x.numel(), item), 3, 1)}
    bound = _bound(2.0 * 2 * xb.numel(), 16.0 * xb.numel(), "float32")
    print(f"spatial mapped D shape={shape} blocks of {h} rows bf16 p=0.1 {json.dumps(exact)} "
          f"ms={json.dumps(ms)} bound_ms={bound['bound_ms']:.4f}")
    if not all(exact.values()):
        raise AssertionError(f"kernel D's block mapping: {exact}")
    return {"mapped_ms": ms["mapped"], "mapped_plain_ms": ms["mapped plain"],
            "unmapped_ms_at_block": ms["unmapped"], "mapped_bound_ms": bound["bound_ms"],
            "mapped_block": list(xb.shape)}


def _e_halo_blocks_exact(randn, dev) -> None:
    """Kernel E SAME on each halo-padded half-height block of a (PAR_BATCH,
    128, 128, 32) bf16 input (a 3x3 convolution to 32 channels), its outer
    rows cropped: the whole image's int8 convolution bit for bit, on both
    routes."""
    x = randn(PAR_BATCH, 128, 128, 32).to(torch.bfloat16)
    qw = int8_e.quantize_weight(randn(32, 32, 3, 3, scale=1 / 17))
    bias = randn(32, scale=0.1)
    s = float(x.float().abs().max()) / 127
    pad = F.pad(x, (0, 0, 0, 0, 1, 1))
    def conv(t, route):
        return int8_e._launch(t, qw, s, bias, None, None, None, None, False, route=route)

    for route in ("wgmma", "mma_sync"):
        whole = conv(x, route)
        got = [conv(pad[:, i * 64:i * 64 + 66].contiguous(), route)[:, 1:65] for i in (0, 1)]
        exact = torch.equal(torch.cat(got, dim=1), whole)
        print(f"spatial E on halo-padded blocks route={route} {tuple(x.shape)} -> 32: "
              f"exact={exact}")
        if not exact:
            raise AssertionError(f"kernel E on halo-padded blocks ({route}) is not the whole "
                                 "image's convolution")


def spatial_kernels_vs_plain(dev) -> dict:
    """The kernels of the spatially sharded step at its block shapes (a
    1 x 2 mesh halves each chain's rows), in this process: split C and C′
    at every chain shape of the flagship U-Net at PAR_BATCH (checked) and at
    the flagship's first chain at bs=128 (also timed), D with the block
    mapping, and E on halo-padded blocks. Returns the timed rows."""
    gen = torch.Generator(device=dev).manual_seed(9090)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    cfg = preset("probunet_multivar_128")
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device="cpu")
    chains = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, a: chains.append((a[0].shape[2], a[0].shape[3], a[0].shape[1], mod.groups)))
        for mod in model.unet.modules() if isinstance(mod, EDMGroupNorm)]
    with torch.no_grad():
        model.unet(torch.zeros(1, *cfg.data.resolution, cfg.model.input_channels))
    for hk in hooks:
        hk.remove()
    for hh, w, c, groups in sorted(set(chains)):
        if not (fused_gn.supported(hh, w, c, groups) and fused_gn.supported(hh // 2, w, c, groups)):
            raise AssertionError(f"chain {(hh, w, c, groups)}: kernel C does not take the "
                                 "half-height block the unsharded step's shape takes")
        _split_chain_vs_plain(randn, dev, (PAR_BATCH, hh, w, c), groups, timed=False)
    rows = _split_chain_vs_plain(randn, dev, GN_CASES[0][0], min(32, GN_CASES[0][0][3] // 4),
                                 timed=True)
    torch.cuda.empty_cache()
    rows["dropout"] = _mapped_dropout_vs_plain(randn, dev, (BATCH, 128, 128, 32))
    _e_halo_blocks_exact(randn, dev)
    torch.cuda.empty_cache()
    return rows


def world_of_one(dev, zero_counts, read_counts) -> dict:
    """``make_parallel_train_step`` in a world of one over NCCL at the
    flagship's training step (bf16, bs=128, M=15, dropout 0.1): one step
    bit-equal to ``make_train_step``'s from the same state and seed
    (parameters and metrics, cuDNN's deterministic algorithms for the
    comparison), kernels A, A′, C and C′ launched; then both steps'
    samples/s in this call. A world of one has no gradient all-reduce (an
    axis of size 1 has no group), so an all-reduce of one flat f32 buffer
    of the gradients' size over the world is timed on its own and set
    against the step. Returns the parallel step's launches."""
    import torch.distributed as dist

    from probunet_tpu_torch.parallel import make_mesh, make_parallel_train_step, multihost

    multihost.initialize(device=dev, init_method=f"tcp://127.0.0.1:{_free_port()}",
                         world_size=1, rank=0)
    try:
        print(f"parallel world of one: backend {dist.get_backend()}, world {dist.get_world_size()}")
        cfg = preset("probunet_multivar_128")
        cfg.model.compute_dtype = "bfloat16"
        cfg.train.ensemble_size = TRAIN_M
        model = _flagship_model(cfg)
        hr = _par_days(TRAIN_BATCH, cfg, dev, seed=41)
        stats = compute_stats(hr, cfg.data.lowres_scale)
        mesh = make_mesh(device=dev)
        states = {name: create_train_state(copy.deepcopy(model), seed=cfg.train.seed,
                                           lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
                                           device=dev) for name in ("single", "parallel")}
        steps = {"single": make_train_step(states["single"].model, cfg),
                 "parallel": make_parallel_train_step(states["parallel"].model, cfg, mesh)}
        det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            zero_counts()
            states["parallel"], met_p = steps["parallel"](states["parallel"], hr, stats, 1.0, 1.0)
            launches = read_counts()
            states["single"], met_s = steps["single"](states["single"], hr, stats, 1.0, 1.0)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        same_metrics = set(met_p) == set(met_s) and all(
            torch.equal(met_p[k], met_s[k]) for k in met_s)
        differ = [n for (n, a), b in zip(states["single"].model.named_parameters(),
                                         states["parallel"].model.parameters())
                  if not torch.equal(a, b)]
        print(f"parallel world of one, bf16 bs={TRAIN_BATCH} M={TRAIN_M}: loss "
              f"{float(met_p['loss']):.9g} vs {float(met_s['loss']):.9g}, grad_norm "
              f"{float(met_p['grad_norm']):.9g} vs {float(met_s['grad_norm']):.9g}; metrics "
              f"bit-equal {same_metrics}; parameters differing {len(differ)}; launches "
              f"{json.dumps(launches)}")
        if not same_metrics or differ:
            raise AssertionError(f"the world-of-one parallel step is not the single step: "
                                 f"metrics equal {same_metrics}, parameters {differ[:5]}")
        for name in ("fcomb_crps", "fcomb_crps_bwd", "fused_gn", "fused_gn_bwd"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the parallel step")
        rates = _step_rates(steps, states, hr, stats,
                            ("single", "parallel", "parallel", "single"))
        n_grad = sum(p.numel() for p in states["parallel"].optimizer.params)
        flat = torch.ones(n_grad, dtype=torch.float32, device=dev)
        ar_ms = _sync_ms(lambda: dist.all_reduce(flat), iters=PAR_STEPS, spin=False)
        step_ms = 1e3 * TRAIN_BATCH / rates["parallel"]
        print(f"parallel world of one: samples/s single {rates['single']:.2f}, parallel "
              f"{rates['parallel']:.2f} (no all-reduce in a world of one); an all-reduce of "
              f"the gradients' size ({n_grad} f32, {n_grad * 4 / 1e6:.1f} MB, "
              f"{dist.get_backend()}, world {dist.get_world_size()}) {ar_ms:.3f} ms, "
              f"{ar_ms / (step_ms + ar_ms):.4f} of a step of {step_ms:.3f} ms plus it")
        del states, steps, flat
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def parallel_phase(dev, zero_counts, read_counts) -> tuple[dict, dict, dict]:
    """The parallel paths on this card: the world of one over NCCL
    (:func:`world_of_one`), then two gloo ranks sharing cuda:0 in one launch
    of two processes (:func:`parallel_rank`), whose last parts are the
    spatially sharded paths and their later options. Returns (the launches
    of each part's data-parallel and member paths, those of each rank's
    spatial paths, those of each rank's spatial options)."""
    launches = {"world of one": world_of_one(dev, zero_counts, read_counts)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as work:
        # a served checkpoint for infer-domain: the flagship, zero parameters filled
        cfg = preset("fulldomain_dp8")
        CheckpointManager(os.path.join(work, "ckpt")).save_best(
            _flagship_model(cfg).state_dict())
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
             "--port", str(port), "--workdir", work, "--device", str(dev)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=PAR_TIMEOUT)[0])
        finally:
            for proc in procs:   # no rank outlives the phase
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for r, (proc, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                print(f"parallel rank{r} | {line[:300]}")
            if proc.returncode != 0 or f"PARALLEL_OK rank={r}" not in out:
                raise AssertionError(f"parallel rank {r} failed (exit {proc.returncode})")
        print(f"parallel two gloo ranks on one card: {time.perf_counter() - t0:.3f} s")
        spatial, options = {}, {}
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                parts = json.load(f)
            launches[f"gloo rank {r}"] = parts["parallel"]
            spatial[f"gloo rank {r}"] = parts["spatial"]
            options[f"gloo rank {r}"] = parts["spatial_options"]
    return launches, spatial, options


def _captured_grads(state: TrainState) -> list:
    """A list that gets the gradients each ``state.optimizer.step`` call
    receives (copies), the call going on as before."""
    seen, step = [], state.optimizer.step

    def capture(grads):
        seen.append([g.detach().clone() for g in grads])
        return step(grads)

    state.optimizer.step = capture
    return seen


@contextlib.contextmanager
def _uncounted():
    """Launches inside are a reference's, not the path's: the counts are
    restored after (the counters count on the host, at each launch)."""
    counters = launch_counters()[0]
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        yield
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


def _dp_steps_vs_one(rank: int, base: ProbabilisticUNet, cfg, mesh, hr, stats) -> None:
    """On both GroupNorm routes, two data-parallel steps of ``base`` over
    ``mesh`` on this rank's slab of ``hr`` against two one-process steps on
    the whole of it (run and held on rank 0, :func:`_dp_agreement`); on
    the kernel route also the planted fault (:func:`_planted_fault`), which
    must fail. The fault's and the reference's launches are not counted."""
    for gn in ("kernel", "composed"):
        model = _variant(base, cfg, gn_impl=gn).to(hr.device)
        runs = {"data-parallel": _two_steps(model, cfg, mesh, hr, stats)}
        if gn == "kernel":
            with _uncounted(), _planted_fault(rank):
                runs["planted fault"] = _two_steps(model, cfg, mesh, hr, stats)
        if rank == 0:
            with _uncounted():
                ref = _two_steps(model, cfg, None, hr, stats)
            for name, run in runs.items():
                _dp_agreement(f"dp step {gn} {name} (bs {hr.shape[0]} over "
                              f"{mesh.size('data')} ranks vs one)", run, ref, cfg.train.lr,
                              fault="share" if name == "planted fault" else None)
            del ref
        del runs, model


def _two_steps(model: ProbabilisticUNet, cfg, mesh, hr, stats, fused: bool = True,
               steps: int = 2):
    """Two (or ``steps``) ELBO train steps from a fresh state on a copy of
    ``model``: the parallel step on this rank's block of ``hr`` (its slab,
    and its rows on a mesh with n_spatial > 1) with ``mesh``, else the
    one-process step on the whole batch; ``fused``: the reconstruction
    route. Returns (state, the steps' metrics, the gradients AdamW received
    at each step)."""
    state = create_train_state(copy.deepcopy(model), seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device=hr.device)
    from probunet_tpu_torch.parallel import make_parallel_train_step, shard_batch

    grads = _captured_grads(state)
    step = (make_train_step(state.model, cfg, fused=fused) if mesh is None
            else make_parallel_train_step(state.model, cfg, mesh, fused=fused))
    batch = hr if mesh is None else shard_batch(hr, mesh)
    metrics = []
    for _ in range(steps):
        state, met = step(state, batch, stats, 1.0, 1.0)
        metrics.append(met)
    return state, metrics, grads


@contextlib.contextmanager
def _planted_fault(rank: int):
    """Rank 1's kernel C/C′ masks are those of rows 0:4, not of its own
    rows: ``fused_gn.slab_seed`` is not applied there."""
    saved = fused_gn.slab_seed
    if rank == 1:
        fused_gn.slab_seed = lambda seed2, batch_offset, row_offset=0: seed2
    try:
        yield
    finally:
        fused_gn.slab_seed = saved


@contextlib.contextmanager
def _planted_row_fault(rank: int):
    """Rank 1's kernel C/C′ seed words carry no row offset: its block of
    rows gets the masks of rows 0:64 of each chain's image."""
    saved = fused_gn.slab_seed
    if rank == 1:
        fused_gn.slab_seed = lambda seed2, batch_offset, row_offset=0: saved(seed2, batch_offset)
    try:
        yield
    finally:
        fused_gn.slab_seed = saved


def _int8_agreement(what: str, got, want, float_want) -> None:
    """A sharded int8 ensemble against the one-process int8 ensemble: each
    int8 convolution of a block is exact, but the blocks' GroupNorm sums,
    added in another order, may move a later convolution's input across a
    rounding boundary of its quantization. So the two are held by their
    distance from the float ensemble (means within SPATIAL_INT8_GAP_SHARE
    of each other), their mean difference (at most SPATIAL_INT8_MEAN_SHARE
    of the mean int8-vs-float gap) and their largest (at most the largest
    gap)."""
    gap, err = (want - float_want).abs(), (got - want).abs()
    got_gap = float((got - float_want).abs().mean())
    print(f"{what}: mean|err| {float(err.mean()):.4e} max|err| {float(err.max()):.4e}; the "
          f"int8-vs-float gap mean {float(gap.mean()):.4e} (sharded {got_gap:.4e}) max "
          f"{float(gap.max()):.4e}")
    if not (float(err.mean()) <= SPATIAL_INT8_MEAN_SHARE * float(gap.mean())
            and float(err.max()) <= float(gap.max())
            and abs(got_gap - float(gap.mean())) <= SPATIAL_INT8_GAP_SHARE * float(gap.mean())):
        raise AssertionError(f"{what}: off the one-process int8 ensemble")


def _spatial_vs_one(rank: int, base: ProbabilisticUNet, cfg, hr, stats, scales) -> None:
    """The spatially sharded paths on a 1 x 2 ("data", "spatial") mesh, each
    rank holding 64 of the 128 rows (f32, full widths, dropout 0.1, global
    batch PAR_BATCH), against the one-process paths on rank 0: two train
    steps on the kernel route, fused (split C/C′, A/A′), and two on the
    composed route, unfused (D with the block mapping, B/B′), each by
    :func:`_dp_agreement`, with a planted fault (rank 1's C seed words
    without the row offset) that the check must catch; the eval step; the
    sample step on a ("data", "spatial", "member") = 1 x 2 x 1 mesh, float
    (within ENSEMBLE_RTOL) and int8 on rank 0's scales (kernel E on
    halo-padded blocks, :func:`_int8_agreement`)."""
    from probunet_tpu_torch.parallel import make_mesh

    dev = hr.device
    mesh = make_mesh(1, 2, device=dev)
    for gn, fused in (("kernel", True), ("composed", False)):
        model = _variant(base, cfg, gn_impl=gn).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs = {"spatial": _two_steps(model, cfg, mesh, hr, stats, fused)}
        torch.cuda.synchronize()
        print(f"spatial step {gn}: two steps on rank {rank} in {time.perf_counter() - t0:.3f} s "
              f"(first includes cuDNN's set-up)")
        if gn == "kernel":
            with _uncounted(), _planted_row_fault(rank):
                runs["planted fault"] = _two_steps(model, cfg, mesh, hr, stats, fused)
        if rank == 0:
            with _uncounted():
                ref = _two_steps(model, cfg, None, hr, stats, fused)
            for name, run in runs.items():
                _dp_agreement(f"spatial step {gn} {'fused' if fused else 'unfused'} {name} "
                              f"(bs {hr.shape[0]}, 128 rows over 2 ranks vs one)", run, ref,
                              cfg.train.lr, fault="share" if name == "planted fault" else None)
            del ref
        del runs, model
    torch.cuda.empty_cache()
    _spatial_eval_and_samples(rank, base.to(dev).eval(), cfg, mesh, hr, stats, scales, "")


def _spatial_eval_and_samples(rank: int, model: ProbabilisticUNet, cfg, mesh, hr, stats,
                              scales, what: str) -> None:
    """The eval step on ``mesh`` (1 x 2) and the sample step on a 1 x 2 x 1
    ("data", "spatial", "member") mesh, float and int8 on ``scales``,
    against the one-process paths on rank 0 (``what`` names the option in
    the lines)."""
    from probunet_tpu_torch.parallel import (make_member_mesh, make_parallel_eval_step,
                                             make_parallel_sample_step, shard_batch)

    dev = hr.device
    got = make_parallel_eval_step(model, cfg, mesh)(shard_batch(hr, mesh), stats,
                                                    torch.Generator(device=dev).manual_seed(5))
    if rank == 0:
        with _uncounted():
            want = make_eval_step(model, cfg)(hr, stats, torch.Generator(device=dev).manual_seed(5))
        for k in ("recon", "kl_mean", "loss"):
            _par_close(f"spatial eval step{what} {k} (rows over 2 ranks vs one)", got[k],
                       want[k], PAR_RTOL)
    smesh = make_member_mesh(n_member=1, n_spatial=2, device=dev)
    eps = cli.batch_noise(0, 1, PAR_SAMPLE_M, PAR_BATCH, cfg.model.latent_dim).to(dev)
    batch = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    lrinterp = lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)[:, None]
    wants = {}
    for name, quant in (("float", None), ("int8", scales)):
        got = make_parallel_sample_step(model, cfg, smesh, PAR_SAMPLE_M, quant=quant)(
            hr, eps, stats)
        if rank == 0:
            with _uncounted(), torch.no_grad(), quantize.attached(model, quant):
                out = model.sample(batch["inputs"], PAR_SAMPLE_M, eps=eps)
            wants[name] = residual_to_hr(out, lrinterp, stats, cfg.data.pipeline,
                                         cfg.data.epsilon, cfg.data.standardization)
            line = (f"spatial sample{what} {name} (1 x 2 x 1 mesh, {PAR_SAMPLE_M} members, rows "
                    f"over 2 ranks vs one)")
            if quant is None:
                _par_close(line, got, wants[name], ENSEMBLE_RTOL)
            else:
                _int8_agreement(line, got, wants[name], wants["float"])


@contextlib.contextmanager
def _planted_range_fault():
    """Every rank takes MS-SSIM's data range from its own slab of the
    targets, not from the global batch's (the port before the range was
    all-reduced)."""
    saved = train_loop._Sharding.data_range
    train_loop._Sharding.data_range = lambda self, target: torch.clamp(
        target.max() - target.min(), min=1e-5)
    try:
        yield
    finally:
        train_loop._Sharding.data_range = saved


def _spatial_options_vs_one(rank: int, base: ProbabilisticUNet, cfg, hr, stats,
                            scales) -> None:
    """The options the spatially sharded step took last, at the same sizes
    as :func:`_spatial_vs_one`, against the one-process paths on rank 0:
    two WMSE + MS-SSIM train steps on the kernel route (split C/C′) on the
    1 x 2 ("data", "spatial") mesh and one L1 step on the composed route
    (D with its block mapping), by :func:`_dp_agreement`; the eval and
    sample steps under bilinear interpolation; and two WMSE + MS-SSIM steps
    on a 2 x 1 data-parallel mesh, whose MS-SSIM data range is the global
    batch's, with a planted fault (each rank's own slab's range) that must
    fail the agreement."""
    from probunet_tpu_torch.parallel import make_mesh

    dev = hr.device
    mesh, dp = make_mesh(1, 2, device=dev), make_mesh(device=dev)
    runs = (("mse+ssim", "kernel", mesh, 2), ("l1", "composed", mesh, 1),
            ("mse+ssim", "kernel", dp, 2))
    for loss, gn, on, steps in runs:
        lcfg = copy.deepcopy(cfg)
        lcfg.loss.loss_type = loss
        model = _variant(base, lcfg, gn_impl=gn).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = {"sharded": _two_steps(model, lcfg, on, hr, stats, steps=steps)}
        torch.cuda.synchronize()
        where = "128 rows over 2 ranks" if on is mesh else "the batch over 2 ranks"
        print(f"spatial {loss} step {gn} ({where}): {steps} step(s) on rank {rank} in "
              f"{time.perf_counter() - t0:.3f} s")
        if on is dp:
            with _uncounted(), _planted_range_fault():
                got["planted fault"] = _two_steps(model, lcfg, on, hr, stats, steps=steps)
        if rank == 0:
            with _uncounted():
                ref = _two_steps(model, lcfg, None, hr, stats, steps=steps)
            for name, run in got.items():
                _dp_agreement(f"spatial {loss} step {gn} {name} (bs {hr.shape[0]}, {where} "
                              f"vs one)", run, ref, cfg.train.lr,
                              fault="any" if name == "planted fault" else None)
            del ref
        del got, model
    torch.cuda.empty_cache()
    bcfg = copy.deepcopy(cfg)
    bcfg.data.interp_mode = "bilinear"
    _spatial_eval_and_samples(rank, base.to(dev).eval(), bcfg, mesh, hr, stats, scales,
                              " bilinear")


def _dp_agreement(what: str, run, ref, lr: float, fault: str | None = None) -> None:
    """Two (or one) data-parallel steps (``run``) against as many
    one-process steps (``ref``), each (state, metrics, gradients) from
    :func:`_two_steps`: at each step the metrics within PAR_RTOL, the
    gradients within PAR_RTOL at the first and PAR_RTOL_STEP2 at the
    second; after the steps, the parameters within PAR_PARAM_LR lr wherever
    every step's gradients are clear of rounding (above PAR_CLEAR times the
    step's largest gradient difference), and at most PAR_MOVED_SHARE of all
    elements beyond 0.1 lr. A planted fault prints every reading and must
    fail: ``fault="share"`` (a wrong dropout mask) the share check itself,
    ``fault="any"`` (a wrong loss) any of the checks."""
    (state, mets, grads), (ref_state, ref_mets, ref_grads) = run, ref
    worst, worst_g2 = 0.0, 0.0
    clear = None
    for i in range(len(mets)):
        for k in ("loss", "recon", "kl_mean", "grad_norm"):
            err = float((mets[i][k].double() - ref_mets[i][k].double()).abs()
                        / ref_mets[i][k].double().abs())
            worst = max(worst, err)
            print(f"{what} step {i + 1} {k}: {float(mets[i][k]):.9g} vs "
                  f"{float(ref_mets[i][k]):.9g}, rel err {err:.3e}")
        dg = max(float((a - b).abs().max()) for a, b in zip(grads[i], ref_grads[i]))
        err = dg / max(float(b.abs().max()) for b in ref_grads[i])
        if i == 0:
            worst = max(worst, err)
        else:
            worst_g2 = err
        print(f"{what} step {i + 1} gradients: max|err|/max|want| = {err:.3e} (limit "
              f"{PAR_RTOL if i == 0 else PAR_RTOL_STEP2})")
        step_clear = [b.abs() > PAR_CLEAR * dg for b in ref_grads[i]]
        clear = step_clear if clear is None else [a & b for a, b in zip(clear, step_clear)]
    diffs = [(a - b).detach().abs() for a, b in zip(state.model.parameters(),
                                                   ref_state.model.parameters())]
    n = sum(d.numel() for d in diffs)
    moved = sum(int((d > 0.1 * lr).sum()) for d in diffs)
    n_clear = sum(int(c.sum()) for c in clear)
    clear_max = max(float(d[c].max()) if bool(c.any()) else 0.0 for d, c in zip(diffs, clear))
    print(f"{what}: parameters after {len(mets)} steps: {moved} of {n} elements ({moved / n:.6f}, "
          f"limit {PAR_MOVED_SHARE}) beyond 0.1 lr (lr {lr:.1e}); over the {n_clear} "
          f"elements clear of rounding max|diff| {clear_max:.3e} = {clear_max / lr:.4f} lr "
          f"(limit {PAR_PARAM_LR} lr); metrics and first gradients worst rel err "
          f"{worst:.3e} (limit {PAR_RTOL})")
    agree = (worst <= PAR_RTOL and worst_g2 <= PAR_RTOL_STEP2
             and moved <= PAR_MOVED_SHARE * n and clear_max <= PAR_PARAM_LR * lr)
    if fault == "share":
        if not moved > PAR_MOVED_SHARE * n:
            raise AssertionError(f"{what}: the planted fault passed the parameter check")
    elif fault == "any":
        if agree:
            raise AssertionError(f"{what}: the planted fault passed every check")
    elif not agree:
        raise AssertionError(f"{what}: off the one-process steps")


def _par_close(what: str, got, want, rtol: float) -> float:
    err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
    print(f"{what}: max|err|/max|want| = {err:.3e} (limit {rtol})")
    if not err <= rtol:
        raise AssertionError(f"{what}: {err} above {rtol}")
    return err


def _offset_kernels_bit_equal(rank: int, dev) -> None:
    """C and C′ on this rank's slab of a (8, 128, 128, 32) batch under the
    seed words ``fused_gn.slab_seed`` shifts by its offset, and D told its
    element offset: bit for bit the rows of the whole batch's outputs (f32 and
    bf16, p = 0.1); the whole batch's masks those of the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(77)
    b, per = PAR_BATCH, PAR_BATCH // 2
    rows = slice(rank * per, (rank + 1) * per)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((b, 128, 128, 32), generator=gen, device=dev).to(dtype)
        g = torch.randn((b, 128, 128, 32), generator=gen, device=dev).to(dtype)
        gamma = 1 + 0.1 * torch.randn(32, generator=gen, device=dev)
        beta = 0.1 * torch.randn(32, generator=gen, device=dev)
        scale = 0.1 * torch.randn((b, 32), generator=gen, device=dev)
        shift = 0.1 * torch.randn((b, 32), generator=gen, device=dev)
        seed = torch.tensor([1234567, -7654321], dtype=torch.int32, device=dev)
        consts = (8, 1e-5, 0.1, True)
        y, mean, rstd = fused_gn._launch(x, gamma, beta, scale, shift, seed, *consts)
        dx, *_ = fused_gn._launch_bwd(x, g, gamma, beta, scale, shift, seed, mean, rstd, 8, 0.1,
                                      True)
        part = (x[rows].contiguous(), gamma, beta, scale[rows].contiguous(),
                shift[rows].contiguous(), fused_gn.slab_seed(seed, rows.start))
        y_s, mean_s, rstd_s = fused_gn._launch(*part, *consts)
        dx_s, *_ = fused_gn._launch_bwd(part[0], g[rows].contiguous(), *part[1:], mean_s,
                                        rstd_s, 8, 0.1, True)
        plain_y = fused_gn.gn_film_silu_dropout_plain(*(t.cpu() for t in (x, gamma, beta,
                                                                           scale, shift, seed)),
                                                       *consts)[0]
        d_whole = dropout._launch(x, seed, 0.1)
        d_slab = dropout._launch(x[rows].contiguous(), seed, 0.1, rows.start * x[0].numel(),
                                 x.numel())
        d_plain = dropout.dropout_plain(x.cpu(), seed.cpu(), 0.1)
        checks = {"C": torch.equal(y_s, y[rows]), "C′": torch.equal(dx_s, dx[rows]),
                  "D": torch.equal(d_slab, d_whole[rows]),
                  "C masks = plain": torch.equal((y == 0).cpu(), plain_y == 0),
                  "D masks = plain": torch.equal((d_whole == 0).cpu(), d_plain == 0)}
        print(f"offset kernels rank {rank} {str(dtype)[6:]} rows {rows.start}:{rows.stop} of "
              f"{b}: {json.dumps(checks)}")
        if not all(checks.values()):
            raise AssertionError(f"offset kernels: {checks}")


def parallel_rank(rank: int, port: int, workdir: str, device: str = "cuda:0") -> None:
    """One of two gloo ranks on ``device``, the parent's card (f32, TF32 off, the flagship's full
    widths, dropout 0.1, a global batch of 8):

    - two data-parallel steps against two one-process steps (rank 0) on
      both GroupNorm routes (kernels C/C′ under seed words shifted by the
      batch offset; the composed chain with kernel D's element offset):
      :func:`_dp_agreement`, which a planted fault must fail;
    - ``make_parallel_sample_step`` on a ("member" = 2) mesh against one
      rank's ``ProbabilisticUNet.sample`` + ``residual_to_hr`` on the same
      noise, float and int8 (rank 0's scales, broadcast);
    - ``infer-domain --dp 2`` on a 140x140 domain (chunks of 3 tiles round
      up to 4) against the one-process command at chunks of 4;
    - ``halo_conv2d`` and the tensor-parallel pair against their unsharded
      counterparts;

    then C, C′ and D on the rank's slab against the whole batch
    (:func:`_offset_kernels_bit_equal`, not counted). Writes the paths'
    launches to ``rank<R>.json``."""
    import torch.distributed as dist

    from probunet_tpu_torch.parallel import (
        channel_sharded_block, halo_conv2d, init_channel_sharded_params,
        make_channel_sharded_apply, make_dp_tp_mesh, make_member_mesh, make_mesh,
        make_parallel_sample_step, multihost, shard_params)
    from probunet_tpu_torch.parallel.mesh import all_gather, mesh_of

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(device=dev, backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=2, rank=rank)
    _build.library()   # built by the parent: loaded, not rebuilt
    _, zero_counts, read_counts = launch_counters()
    cfg = preset("probunet_multivar_128")
    cfg.train.ensemble_size = TRAIN_M
    base = _flagship_model(cfg)
    hr = _par_days(PAR_BATCH, cfg, dev, seed=43)
    stats = compute_stats(hr, cfg.data.lowres_scale)
    zero_counts()
    _dp_steps_vs_one(rank, base, cfg, make_mesh(device=dev), hr, stats)
    torch.cuda.empty_cache()

    # member sharding: float and int8, against one rank's sample path
    model = base.to(dev).eval()
    mmesh = make_member_mesh(n_member=2, device=dev)
    eps = cli.batch_noise(0, 0, PAR_SAMPLE_M, PAR_BATCH, cfg.model.latent_dim).to(dev)
    batch = preprocess_batch(hr, stats, cfg.data.pipeline, cfg.data.lowres_scale,
                             cfg.data.interp_mode, cfg.data.epsilon, cfg.data.standardization)
    scales = None
    if rank == 0:
        with _uncounted():   # set-up, not the member-sharded path
            scales = quantize.calibrate_sample(model, [batch["inputs"]], PAR_SAMPLE_M)
    box = [scales]
    dist.broadcast_object_list(box, src=0)
    for name, quant in (("float", None), ("int8", box[0])):
        got = make_parallel_sample_step(model, cfg, mmesh, PAR_SAMPLE_M, quant=quant)(
            hr, eps, stats)
        if rank == 0:
            with _uncounted(), torch.no_grad(), quantize.attached(model, quant):
                out = model.sample(batch["inputs"], PAR_SAMPLE_M, eps=eps)
            want = residual_to_hr(out, lrinterp_from_batch(batch, cfg.data.lowres_scale,
                                                           cfg.data.interp_mode)[:, None],
                                  stats, cfg.data.pipeline, cfg.data.epsilon,
                                  cfg.data.standardization)
            _par_close(f"member sharding {name} (2 ranks x {PAR_SAMPLE_M // 2} members vs "
                       f"one rank's sample)", got, want, ENSEMBLE_RTOL)

    # infer-domain --dp 2 against the one-process command
    argv = ["infer-domain", "--preset", "fulldomain_dp8", "--ckpt", os.path.join(workdir, "ckpt"),
            "--domain", "140", "--days", "2", "--members", "4",
            "--set", f"data.years_test={json.dumps(INFER_DOMAIN_YEARS)}"]
    res, _ = cli.main(argv[:1] + ["--outdir", os.path.join(workdir, f"dp{rank}"), "--dp", "2",
                                  "--batch-tiles", "3"] + argv[1:])
    if rank == 0:
        with _uncounted():
            one, _ = cli.main(argv[:1] + ["--outdir", os.path.join(workdir, "one"),
                                          "--batch-tiles", "4"] + argv[1:])
        print(f"infer-domain --dp 2: {json.dumps(res)}; one process: {json.dumps(one)}")
        _par_close("infer-domain --dp 2 vs one process (140x140, 2 days, M=4)",
                   torch.tensor(res["crps_mean"] + res["mae_mean"]),
                   torch.tensor(one["crps_mean"] + one["mae_mean"]), ENSEMBLE_RTOL)

    # halo_conv2d and the tensor-parallel pair
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((PAR_BATCH, 128, 128, 32), generator=gen, device=dev)
    w = torch.randn((32, 32, 3, 3), generator=gen, device=dev) / math.sqrt(288)
    smesh = mesh_of({"spatial": 2}, device=dev)
    mine = halo_conv2d(x.chunk(2, dim=1)[rank].contiguous(), w, smesh)
    halo = torch.cat(all_gather(mine.contiguous(), smesh, "spatial"), dim=1)
    tp = init_channel_sharded_params(torch.Generator(device=dev).manual_seed(6), 32, 64, 32)
    tmesh = make_dp_tp_mesh(n_model=2, device=dev)
    tp_out = make_channel_sharded_apply(tmesh)(shard_params(tp, tmesh), x)
    if rank == 0:
        _par_close("halo_conv2d (rows over 2 ranks) vs F.conv2d SAME", halo,
                   F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1), 1e-5)
        _par_close("tensor-parallel pair (Cmid 64 over 2 ranks) vs unsharded", tp_out,
                   channel_sharded_block(tp, x), 1e-5)
    launches = read_counts()
    print(f"parallel rank {rank} launches: {json.dumps(launches)}")
    _offset_kernels_bit_equal(rank, dev)
    # the spatially sharded paths: their own launch counts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero_counts()
    _spatial_vs_one(rank, base, cfg, hr, stats, box[0])
    spatial = read_counts()
    print(f"spatial rank {rank} launches: {json.dumps(spatial)}; spatial part "
          f"{time.perf_counter() - t0:.3f} s")
    for name in ("fcomb_crps", "fcomb_crps_bwd", "afcrps", "afcrps_bwd", "fused_gn_split",
                 "fused_gn_bwd_split", "dropout", "int8_conv", "avg_pool"):
        if spatial[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the spatial path")
    # the spatially sharded step's later options: their own launch counts
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero_counts()
    _spatial_options_vs_one(rank, base, cfg, hr, stats, box[0])
    options = read_counts()
    print(f"spatial options rank {rank} launches: {json.dumps(options)}; spatial options "
          f"part {time.perf_counter() - t0:.3f} s")
    for name in ("fused_gn", "fused_gn_bwd", "fused_gn_split", "fused_gn_bwd_split", "dropout",
                 "int8_conv", "avg_pool"):
        if options[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the spatial options' path")
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"parallel": launches, "spatial": spatial, "spatial_options": options}, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"PARALLEL_OK rank={rank}", flush=True)


def launch_counters():
    """(the kernel wrappers by name, a function setting their launch counts
    to 0, a function reading them after the device has finished)."""
    counters = {"fcomb_crps": fcomb_crps.fcomb_crps_terms,
                "fcomb_crps_bwd": fcomb_crps.fcomb_crps_terms_bwd,
                "afcrps": afcrps.ensemble_crps_terms,
                "afcrps_bwd": afcrps.ensemble_crps_terms_bwd,
                "fused_gn": fused_gn.gn_film_silu_dropout,
                "fused_gn_bwd": fused_gn.gn_film_silu_dropout_bwd,
                # C's and C′'s split route (a block of rows under a spatial mesh)
                "fused_gn_split": fused_gn.gn_split_fwd,
                "fused_gn_bwd_split": fused_gn.gn_split_bwd,
                "dropout": dropout.dropout,
                "int8_conv": int8_e.int8_conv,                  # E, either route
                "int8_conv_wgmma": int8_e.launch_wgmma,
                "int8_conv_mma_sync": int8_e.launch_mma_sync,
                "act_compress_quantize": act_compress.quantize_channels,       # F
                "act_compress_dequantize": act_compress.dequantize,           # F′
                "avg_pool": avg_pool_g.window_mean}                           # G

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in counters.items()}

    return counters, zero_counts, read_counts


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
    card = _card()
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
    int8_device_vs_cpu(model32, hr_cpu, stats_cpu, cfg32, dev)
    train_device_vs_cpu(model32, hr_cpu, stats_cpu, cfg32, dev)
    del model32
    new_branches_device_vs_cpu(dev)
    model = model.to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: probunet_multivar_128 bf16, {n_params} parameters")

    counters, zero_counts, read_counts = launch_counters()

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

    # int8 serving: kernel E on the sample and eval-ELBO paths
    e_rows, int8_launches = int8_phase(model, batches, stats, cfg, dev, zero_counts,
                                       read_counts)
    print(f"launches on the int8 serve runs: {json.dumps(int8_launches)}")
    report.update(e_rows)
    report["int8_conv"]["mma_sync_ms_at_main"] = report.pop("int8_conv_mma_sync_at_main")["ms"]

    # the training path: bs=128, M=15, dropout 0.1, on six routes
    cfg_train = copy.deepcopy(cfg)
    cfg_train.train.ensemble_size = TRAIN_M
    avg_pool_launches_per_step(model, batches[0][:8], stats, cfg_train, dev, zero_counts,
                               read_counts, card)
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
        # E serves only (no gradient); C and C′ split only under a spatial mesh;
        # F and F′ run only under PROBUNET_ACT_COMPRESS=int8 (their own phase)
        if n <= 0 and not name.startswith("int8_conv") and not name.endswith("_split") \
                and name not in ACT8_KERNELS:
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

    # EDM at the reference baseline's widths on the flagship's data
    del model, model_composed, remats, routes, m
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    edm_launches = edm_phase(dev, hr, stats, zero_counts, read_counts)
    print(f"launches on the EDM runs: {json.dumps(edm_launches)}; edm phase "
          f"{time.perf_counter() - t0:.3f} s")
    del hr, hr_phys, batches
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # the serve CLI: pack, evaluate (f32 and bf16), extremes, card vs CPU
        cli_launches = cli_phase(dev, zero_counts, read_counts, os.path.join(work, "cli"))
        print(f"launches on the serve CLI's runs: {json.dumps(cli_launches)}")
        # the training CLI: pack, train (three settings), the deterministic baselines
        train_dir = os.path.join(work, "train")
        train_cli_launches = train_cli_phase(dev, zero_counts, read_counts, train_dir)
        print(f"launches on the training CLI's runs: {json.dumps(train_cli_launches)}")
        # explore on the flagship checkpoint of the training CLI's preset run,
        # over the packed test split of the serve CLI phase
        t0 = time.perf_counter()
        explore_launches = explore_phase(
            dev, os.path.join(work, "cli", "test.npz"),
            os.path.join(_run_dir(train_dir, f"train {TRAIN_CLI_RUNS[0][0]}"), "ckpt"),
            zero_counts, read_counts)
        print(f"launches on the explore runs: {json.dumps(explore_launches)}; explore phase "
              f"{time.perf_counter() - t0:.3f} s")
        # int8 serving on that trained checkpoint, card against CPU
        int8_trained_device_vs_cpu(
            dev, os.path.join(work, "cli", "test.npz"),
            os.path.join(_run_dir(train_dir, f"train {TRAIN_CLI_RUNS[0][0]}"), "ckpt"))

    # the benchmark: each mode of `python -m probunet_tpu_torch bench`
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_launches = bench_phase(zero_counts, read_counts)
    print(f"launches on the bench runs: {json.dumps(bench_launches)}; bench phase "
          f"{time.perf_counter() - t0:.3f} s")

    # int8 saved convolution inputs: kernels F and F′, the compressed steps and
    # `bench` train with compression off and on
    torch.cuda.empty_cache()
    act8_rows, act8_launches = act_compress_phase(dev, zero_counts, read_counts)
    report.update(act8_rows)
    print(f"launches on the act_compress runs: {json.dumps(act8_launches)}")

    # the parallel paths: a world of one over NCCL, two gloo ranks on this card
    # (the spatially sharded paths last); the split kernels at the block shapes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name, rows in spatial_kernels_vs_plain(dev).items():
        report[name].update(rows)
    print(f"spatial kernels at the block shapes: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    parallel_launches, spatial_launches, options_launches = parallel_phase(
        dev, zero_counts, read_counts)
    print(f"launches on the parallel runs: {json.dumps(parallel_launches)}; on the spatial "
          f"runs: {json.dumps(spatial_launches)}; on the spatial options' runs: "
          f"{json.dumps(options_launches)}; parallel phase {time.perf_counter() - t0:.3f} s")

    modules = {"fcomb_crps": fcomb_crps, "afcrps": afcrps, "fused_gn": fused_gn,
               "dropout": dropout, "avg_pool": avg_pool_g}
    kernels = []
    # E's entries are its two routes' kernels, each counted by its route
    e_counters = {"int8_conv": "int8_conv_wgmma", "int8_conv_mma_sync": "int8_conv_mma_sync"}
    splits = {"fused_gn": "fused_gn_split", "fused_gn_bwd": "fused_gn_bwd_split"}
    # F's and F′'s main path: `bench` train under PROBUNET_ACT_COMPRESS=int8
    act8_main = act8_launches[f"bench train act_compress=int8 bs={ACT8_BENCH_BS[0]}"]
    for name in [n for n in counters if not n.startswith("int8_conv")
                 and n not in splits.values() and n not in ACT8_KERNELS] + list(e_counters) \
            + list(ACT8_KERNELS):
        counter = e_counters.get(name, name)
        mod = (int8_e if name in e_counters else act_compress if name in ACT8_KERNELS
               else modules[name.removesuffix("_bwd")])
        replaces = (mod.REPLACES_BWD if name.endswith("_bwd") else
                    mod.REPLACES_DEQUANTIZE if name == "act_compress_dequantize"
                    else mod.REPLACES)
        int8_n = sum(r[counter] for r in int8_launches.values())
        main_n = (int8_n if name in e_counters else act8_main[counter] if name in ACT8_KERNELS
                  else launches[counter])
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": replaces,
                        # each kernel's own main path: training for A to D and G,
                        # int8 serving for E, compressed training for F and F′
                        "launches": main_n,
                        **report[name], "launches_int8": int8_n,
                        "launches_cli": sum(r[counter] for r in cli_launches.values()),
                        "launches_train_cli": sum(r[counter]
                                                  for r in train_cli_launches.values()),
                        "launches_edm": sum(r[counter] for r in edm_launches.values()),
                        "launches_explore": sum(r[counter]
                                                for r in explore_launches.values()),
                        "launches_bench": sum(r[counter] for r in bench_launches.values()),
                        "launches_act_compress": sum(r[counter]
                                                     for r in act8_launches.values()),
                        "launches_parallel": sum(r[counter]
                                                 for r in parallel_launches.values()),
                        # the spatially sharded runs (both ranks): C and C′
                        # launch only their split route there
                        "launches_spatial": sum(r[counter] for r in spatial_launches.values()),
                        # the spatial options' runs (both ranks): the MS-SSIM
                        # and L1 ELBOs, bilinear, the 2 x 1 MS-SSIM steps
                        "launches_spatial_options": sum(r[counter]
                                                        for r in options_launches.values()),
                        **({"launches_spatial_split": sum(r[splits[name]]
                                                          for r in spatial_launches.values()),
                            "launches_spatial_options_split": sum(
                                r[splits[name]] for r in options_launches.values())}
                           if name in splits else {})})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    _args = argparse.ArgumentParser(description="smoke run of the port on one GPU")
    _args.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    _args.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    _args.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    _args.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)
    _a = _args.parse_args()
    if _a.parallel_rank is None:
        main()
    else:   # one of parallel_phase's two ranks
        parallel_rank(_a.parallel_rank, _a.port, _a.workdir, _a.device)
