"""Training and evaluation steps and the epoch loop (port of
``probunet_tpu/train/loop.py``).

``make_train_step`` is the ELBO training step (``bench.py``'s default
mode in the JAX package): device-side preprocessing of a raw HR batch,
the posterior ELBO at M = ``ensemble_size`` with the U-Net's dropout on,
its backward (through kernels A′ or B′, and C′ or D by the model's
GroupNorm route), and AdamW as optax
computes it. Its random numbers come from a generator seeded from
(seed, step) on the batch's device. ``make_eval_step`` is the no-grad
ELBO users call between epochs and in ``bench.py``'s eval mode (M =
``eval_ensemble_size``, beta_1 = 0, no dropout), in float or, with a
calibrated scales tree (``quant=``), on int8 convolutions (kernel E).
``make_deterministic_train_step`` is the deterministic baselines' MSE
step. ``train_epoch``, ``eval_model`` and :class:`Trainer` loop them over
``ClimexDataset`` splits as the JAX loop does, the batches copied to the
device ahead of the step by ``data.loader.prefetch_to_device``; the
``Trainer`` also draws the per-epoch sample figures. ``Trainer(mesh=...)``
trains data-parallel (``make_train_step(mesh=)``): every rank shuffles
alike, loads its slab of each global batch (and, with n_spatial > 1, its
block of rows) and takes the parallel steps; only rank 0 writes
checkpoints, logs and figures.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.data.climex import (
    Standardization,
    lrinterp_from_batch,
    preprocess_batch,
)
from probunet_tpu_torch.data.loader import Batches, prefetch_to_device
from probunet_tpu_torch.device import resolve_device
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.ops import quantize
from probunet_tpu_torch.ops.msssim import LEVELS as MSSSIM_SCALES
from probunet_tpu_torch.train.early_stop import EarlyStopper
from probunet_tpu_torch.train.schedule import beta_schedule
from probunet_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    global_norm,
    step_generator,
)
from probunet_tpu_torch.utils.profiling import Throughput, device_sync, span


def make_elbo_loss_fn(model: ProbabilisticUNet, cfg: Config, training: bool = True,
                      fused: bool = True, quant: dict | None = None,
                      collect_stats: bool = False, mesh=None) -> Callable:
    """ELBO loss of (hr_batch, stats, generator, beta_0, beta_1[, eps,
    seeds]) -> (total, metrics). ``training``: M = ``ensemble_size`` and
    the U-Net's dropout on; else M = ``eval_ensemble_size``, no dropout.
    ``fused`` selects the reconstruction route (kernel A, or
    ``Fcomb.ensemble`` + kernel B). ``eps``/``seeds`` override the draws
    from ``generator`` (the tests hand both packages the same values);
    ``slab`` = (first row, global batch) of a data-parallel rank's batch
    (``ProbabilisticUNet.elbo``; ``eps`` is then the global batch's);
    ``rows`` (``parallel.spatial.Rows``): the batch is this rank's block
    of image rows (``preprocess_batch`` and ``elbo`` take it). ``mesh``:
    the mesh of ``slab`` and ``rows``, over which the ``"mse+ssim"`` ELBO
    takes MS-SSIM's data range: the global batch's targets' max - min,
    once a call; and a model built with ``act_compress`` each compressed
    convolution's absmax.

    ``quant``: a scales tree (``ops.quantize``), attached to the model for
    the call: the convolutions that find their scale run int8 (kernel E; no
    gradient, so eval use only). ``collect_stats``: the call records each
    hooked convolution's input absmax and returns the tree in
    ``metrics["quant_stats"]``, the calibration pass of this exact path."""
    data_cfg, loss_cfg = cfg.data, cfg.loss
    m_size = cfg.train.ensemble_size if training else cfg.train.eval_ensemble_size
    sharding = _Sharding(mesh, cfg)

    def loss_fn(hr_batch: torch.Tensor, stats: Standardization,
                generator: torch.Generator, beta_0: float, beta_1: float,
                eps: torch.Tensor | None = None, seeds: torch.Tensor | None = None,
                slab: tuple[int, int] | None = None, rows=None):
        batch = preprocess_batch(
            hr_batch, stats, data_cfg.pipeline, data_cfg.lowres_scale,
            data_cfg.interp_mode, data_cfg.epsilon, data_cfg.standardization, rows)
        data_range = (sharding.data_range(batch["targets"])
                      if loss_cfg.loss_type == "mse+ssim" else None)
        recorder = (quantize.record_absmax(model) if collect_stats
                    else contextlib.nullcontext())
        with quantize.attached(model, quant), recorder:
            total, metrics = model.elbo(
                batch["inputs"], batch["targets"], M=m_size, loss_type=loss_cfg.loss_type,
                beta_0=beta_0, beta_1=beta_1, beta_2=loss_cfg.beta_2, alpha=loss_cfg.alpha,
                alpha_w=loss_cfg.alpha_w, beta_w=loss_cfg.beta_w, lam_w=loss_cfg.lam_w,
                generator=generator, eps=eps, fused=fused, training=training, seeds=seeds,
                slab=slab, rows=rows, data_range=data_range, mesh=mesh)
        if collect_stats:
            metrics = {**metrics, "quant_stats": recorder.stats()}
        return total, metrics

    return loss_fn


class _Sharding:
    """How a step over ``mesh`` places its batch (no mesh: one process).

    ``blocks(hr)``: (the slab (first row, global batch), the
    ``parallel.spatial.Rows`` of the image rows) of a local batch; ``grads``
    averages the gradients over ("data", "spatial"), one all-reduce
    (``mesh.mean_over``; the convention in ``parallel/spatial.py``);
    ``metrics`` averages a list of metrics over "data" (they are alike
    over "spatial" already); ``data_range`` is MS-SSIM's data range of the
    global batch's targets."""

    def __init__(self, mesh, cfg: Config):
        self.mesh = mesh
        self.levels = max(len(cfg.model.channel_mult), len(cfg.model.num_filters))
        self.scale = cfg.data.lowres_scale
        self.msssim_scales = MSSSIM_SCALES if cfg.loss.loss_type == "mse+ssim" else 0

    def blocks(self, hr: torch.Tensor):
        if self.mesh is None:
            return None, None
        from probunet_tpu_torch.parallel.multihost import data_slab
        from probunet_tpu_torch.parallel.spatial import check_block, rows_of

        rows = rows_of(self.mesh, hr.shape[1])
        if rows is not None:
            check_block(hr.shape[1], self.scale, self.levels, self.msssim_scales)
        return data_slab(self.mesh, hr.shape[0]), rows

    def data_range(self, target: torch.Tensor) -> torch.Tensor:
        """max - min of the global batch's targets (at least 1e-5), from
        this rank's block ``target``: one all-reduce of (max, -min) with MAX
        over ("data", "spatial"). No gradient: the target carries none."""
        ext = torch.stack([target.max(), -target.min()]).detach()
        if self.mesh is not None:
            from probunet_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, all_reduce_

            all_reduce_(ext, self.mesh, (DATA_AXIS, SPATIAL_AXIS), op="max")
        return torch.clamp(ext[0] + ext[1], min=1e-5)

    def grads(self, tensors: list) -> list:
        from probunet_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, mean_over

        return tensors if self.mesh is None else mean_over(tensors, self.mesh,
                                                           (DATA_AXIS, SPATIAL_AXIS))

    def metrics(self, metrics: dict, skip: tuple = ()) -> dict:
        if self.mesh is None:
            return metrics
        from probunet_tpu_torch.parallel.mesh import mean_over

        names = [k for k in metrics if k not in skip]
        return {**metrics, **dict(zip(names, mean_over([metrics[k] for k in names],
                                                       self.mesh)))}


def make_train_step(model: ProbabilisticUNet, cfg: Config, fused: bool = True,
                    mesh=None) -> Callable:
    """The ELBO train step:

        step(state, hr_batch, stats, beta_0, beta_1[, eps, seeds])
            -> (state, {"loss", "recon", "kl_mean", "grad_norm", ...})

    with the loss's own metrics besides (``wmse`` and ``msssim`` for
    ``"mse+ssim"``, ``recon_per_channel`` and ``kl2_mean`` for ``"l1"``).

    ``hr_batch`` is the raw HR window (B, H, W, C) in storage space, on the
    state's device. The state's model is updated in place and its step
    advanced; ``grad_norm`` is the global norm of the raw gradients (0-d
    tensors on the device; nothing waits for the device).

    ``mesh`` (``parallel.make_mesh``): the data-parallel step
    (``parallel.data_parallel``). ``hr_batch`` is then this rank's slab of
    the global batch (with n_spatial > 1 its block of image rows) and
    ``eps`` the global batch's noise; the draws and dropout masks are the
    global batch's, the gradients are averaged over ("data", "spatial")
    and the metrics over "data" (one all-reduce each) before AdamW and
    ``grad_norm``, and every rank gets what the step returns for the
    global batch. A block whose rows do not divide by the pooling factor
    and the levels' pools raises ``ValueError``."""
    loss_fn = make_elbo_loss_fn(model, cfg, training=True, fused=fused, mesh=mesh)
    sharding = _Sharding(mesh, cfg)

    def step(state: TrainState, hr_batch: torch.Tensor, stats: Standardization,
             beta_0: float, beta_1: float, eps: torch.Tensor | None = None,
             seeds: torch.Tensor | None = None):
        gen = step_generator(state.seed, state.step, hr_batch.device)
        with span("train.forward"):
            loss, metrics = loss_fn(hr_batch, stats, gen, beta_0, beta_1, eps, seeds,
                                    *sharding.blocks(hr_batch))
        params = state.optimizer.params
        with span("train.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            # optax decays every parameter: one that autograd does not reach
            # (the prior at beta_1 = 0) gets a zero gradient, not None
            grads = sharding.grads([torch.zeros_like(p) if g is None else g
                                    for p, g in zip(params, grads)])
        with span("train.optimizer"):
            grad_norm = global_norm(grads)
            state.optimizer.step(grads)
        state.step += 1
        out = {"loss": loss.detach(), "grad_norm": grad_norm}
        out.update({k: v.detach() for k, v in metrics.items() if k != "kl"})
        return state, sharding.metrics(out, skip=("grad_norm",))

    return step


def make_eval_step(model: ProbabilisticUNet, cfg: Config, fused: bool = True,
                   quant: dict | None = None, mesh=None) -> Callable:
    """No-grad posterior ELBO: step(hr_batch, stats, generator) ->
    {"recon", "kl_mean", "loss"} (0-d tensors on the batch's device).
    ``quant``: a calibrated scales tree
    (``ops.quantize.calibrate_elbo``): the step serves int8 convolutions.
    ``mesh``: ``hr_batch`` is this rank's slab (and block of rows), the
    noise is drawn at the global batch's shape, and every rank gets the
    global batch's means."""
    loss_fn = make_elbo_loss_fn(model, cfg, training=False, fused=fused, quant=quant,
                                mesh=mesh)
    sharding = _Sharding(mesh, cfg)

    @torch.no_grad()
    def step(hr_batch: torch.Tensor, stats: Standardization,
             generator: torch.Generator) -> dict[str, torch.Tensor]:
        slab, rows = sharding.blocks(hr_batch)
        total, metrics = loss_fn(hr_batch, stats, generator, 1.0, 0.0, slab=slab, rows=rows)
        return sharding.metrics({"recon": metrics["recon"], "kl_mean": metrics["kl_mean"],
                                 "loss": total})

    return step


def make_deterministic_train_step(model: nn.Module, cfg: Config) -> Callable:
    """The MSE train step of the deterministic baselines (``UNetAll``,
    ``LinearCNN``) on ``preprocess_batch``'s targets:

        step(state, hr_batch, stats[, seeds]) -> (state, {"loss", "loss_per_var"})

    ``loss_per_var`` is the (C,) MSE per variable, ``loss`` their mean. The
    U-Net's dropout seed words come from the step's generator, seeded from
    (seed, step) as the ELBO step's, unless ``seeds`` gives them."""
    data_cfg = cfg.data

    def step(state: TrainState, hr_batch: torch.Tensor, stats: Standardization,
             seeds: torch.Tensor | None = None):
        gen = step_generator(state.seed, state.step, hr_batch.device)
        batch = preprocess_batch(
            hr_batch, stats, data_cfg.pipeline, data_cfg.lowres_scale,
            data_cfg.interp_mode, data_cfg.epsilon, data_cfg.standardization)
        pred = model(batch["inputs"], train=True, seeds=seeds, generator=gen)
        err = (pred - batch["targets"]) ** 2
        per_var = err.mean(dim=tuple(range(err.dim() - 1)))         # (C,)
        loss = per_var.mean()
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        state.optimizer.step(grads)
        state.step += 1
        return state, {"loss": loss.detach(), "loss_per_var": per_var.detach()}

    return step


# ---------------------------------------------------------------------------
# Epoch runners
# ---------------------------------------------------------------------------

def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _hr_batches(dataset, batches: Batches, device: torch.device, mesh=None):
    """The dataset's raw HR batches of ``batches`` on ``device``, prefetched;
    with ``mesh``, this rank's slab of each (and its block of image rows
    on a mesh with n_spatial > 1)."""
    rows = slice(None)
    if mesh is not None:
        from probunet_tpu_torch.parallel.mesh import row_sharding
        from probunet_tpu_torch.parallel.multihost import process_local_indices

        batches = (process_local_indices(idx, mesh) for idx in batches)
        rows = row_sharding(mesh, dataset.hr.shape[1])
    return prefetch_to_device((np.ascontiguousarray(dataset.get_hr_batch(idx)[:, rows])
                               for idx in batches), device=device)


def train_epoch(step_fn: Callable, state: TrainState, dataset, stats: Standardization,
                cfg: Config, beta_0: float, beta_1: float, epoch: int, logger=None,
                ckpt=None, mesh=None) -> tuple[TrainState, dict[str, float]]:
    """One training epoch over ``dataset`` (a ``ClimexDataset``: its
    ``get_hr_batch``), shuffled from ``cfg.train.seed + epoch``, drop-last,
    the batches prefetched to the state's device (reference
    src/train_prob_unet_model.py:105-158). With ``ckpt`` and
    ``cfg.train.checkpoint_every`` > 0 a checkpoint is written every N
    steps. With ``mesh`` (and the data-parallel ``step_fn``) every rank
    visits the same global batches and loads its slab of each.

    The rates (``steps_per_sec``, ``samples_per_sec``) leave the first
    step out: their window opens once its output is on the host, and
    ``first_step_s`` is the time from the epoch's start to then (the first
    batch, compilation and the first step). An epoch of one step has no
    rate (0.0)."""
    batches = Batches(len(dataset), cfg.train.batch_size, shuffle=True,
                      seed=cfg.train.seed + epoch)
    recon_vals, kl_vals = [], []
    every = cfg.train.checkpoint_every
    rate = Throughput(cfg.train.batch_size)
    t0 = time.perf_counter()
    n = 0
    for hr in _hr_batches(dataset, batches, _device(state), mesh):
        state, metrics = step_fn(state, hr, stats, beta_0, beta_1)
        n += 1
        if n == 1:
            device_sync(metrics["recon"])
            first_step_s = time.perf_counter() - t0
            rate.start()
        else:
            rate.step()
        if logger is not None and n % cfg.train.log_every == 0:
            logger.log(metrics, step=state.step, kind="train")
        if ckpt is not None and every and state.step % every == 0:
            ckpt.save(state.step, state, extra={"epoch": epoch})
        recon_vals.append(metrics["recon"])
        kl_vals.append(metrics["kl_mean"])
    if not recon_vals:
        raise ValueError("train_epoch: fewer items than one batch")
    # one host sync at the epoch's end, which closes the rate's window
    mean_recon = float(torch.stack(recon_vals).mean())
    mean_kl = float(torch.stack(kl_vals).mean())
    return state, {"recon": mean_recon, "kl": mean_kl, **rate.summary(),
                   "first_step_s": first_step_s}


def eval_model(eval_step_fn: Callable, state: TrainState, dataset, stats: Standardization,
               cfg: Config, epoch: int = 0, mesh=None) -> dict[str, float]:
    """Mean recon / KL over ``dataset`` in order, drop-last (reference
    src/train_prob_unet_model.py:161-210). The posterior noise comes from
    one generator on the state's device, seeded from (cfg.train.seed +
    7919, epoch) and drawn in batch order. With ``mesh`` (and the
    data-parallel ``eval_step_fn``, whose means are all-reduced) each rank
    loads its slab of each batch."""
    dev = _device(state)
    gen = torch.Generator(device=dev)
    gen.manual_seed((cfg.train.seed + 7919) * 1_000_003 + epoch)
    recon_vals, kl_vals = [], []
    for hr in _hr_batches(dataset, Batches(len(dataset), cfg.train.batch_size), dev, mesh):
        metrics = eval_step_fn(hr, stats, gen)
        recon_vals.append(metrics["recon"])
        kl_vals.append(metrics["kl_mean"])
    if not recon_vals:
        raise ValueError("eval_model: fewer items than one batch")
    return {"recon": float(torch.stack(recon_vals).mean()),
            "kl": float(torch.stack(kl_vals).mean())}


class Trainer:
    """Training with beta annealing, per-epoch validation on the validation
    split's own statistics, early stopping, checkpointing and sample
    figures (the reference's training script, src/main.py:107-238), over
    ``ClimexDataset`` splits. Runs on the CUDA device unless the caller
    passes ``device="cpu"``; trains ``model`` from a new state unless it is
    given a ``state`` (``cli.make_model`` builds the config's model).

    ``mesh`` (``parallel.make_mesh``): data-parallel training on the mesh's
    device with the steps' ``mesh=`` form; the model must be alike
    on every rank (checked against rank 0's), every rank runs the same
    epochs, and only rank 0 logs, checkpoints and draws. The history equals
    the single-process ``Trainer``'s."""

    def __init__(self, cfg: Config, model: ProbabilisticUNet, dataset_train,
                 dataset_val=None, logger=None, checkpoint_manager=None,
                 state: TrainState | None = None, plot_dir: str | None = None,
                 plot_every: int = 1, mesh=None, fused: bool = True,
                 device: str | torch.device | None = "cuda"):
        from probunet_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"Trainer(mesh=...) takes a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        main = mesh is None or mesh.is_main
        self.dataset_train, self.dataset_val = dataset_train, dataset_val
        self.logger = logger if main else None
        self.ckpt = checkpoint_manager if main else None
        self.plot_dir, self.plot_every = (plot_dir if main else None), plot_every
        if state is None:
            state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                                       weight_decay=cfg.train.weight_decay,
                                       grad_clip=cfg.train.grad_clip, accum=cfg.train.accum,
                                       device=self.device)
        self.state = state
        self.model = state.model
        self.stats = dataset_train.device_stats(self.device)
        if mesh is not None:
            from probunet_tpu_torch.parallel.multihost import replicate_global

            replicate_global(dict(self.model.state_dict()), mesh)
        self.train_step = make_train_step(self.model, cfg, fused=fused, mesh=mesh)
        self.eval_step = make_eval_step(self.model, cfg, fused=fused, mesh=mesh)
        self.stopper = EarlyStopper(cfg.train.patience, cfg.train.min_delta)
        self.history = {"train_crps": [], "train_kl": [], "val_crps": [], "val_kl": []}

    def fit(self, num_epochs: int | None = None) -> dict:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.train.num_epochs
        for epoch in range(1, num_epochs + 1):
            beta_0, beta_1 = beta_schedule(epoch, num_epochs, cfg.loss.warmup_epochs,
                                           cfg.loss.max_beta_1)
            self.state, summary = train_epoch(
                self.train_step, self.state, self.dataset_train, self.stats, cfg, beta_0,
                beta_1, epoch, logger=self.logger, ckpt=self.ckpt, mesh=self.mesh)
            self.history["train_crps"].append(summary["recon"])
            self.history["train_kl"].append(summary["kl"])
            rec = {"epoch": epoch, "beta_0": beta_0, "beta_1": beta_1,
                   **{f"train_{k}": v for k, v in summary.items()}}
            if self.dataset_val is not None:
                val = eval_model(self.eval_step, self.state, self.dataset_val,
                                 self.dataset_val.device_stats(self.device), cfg, epoch,
                                 self.mesh)
                self.history["val_crps"].append(val["recon"])
                self.history["val_kl"].append(val["kl"])
                rec.update({f"val_{k}": v for k, v in val.items()})
                stop, params = self.stopper.early_stop(val["recon"], self.model.state_dict())
                if self.ckpt is not None and self.stopper.counter == 0:
                    self.ckpt.save_best(self.stopper.best_params)
                if stop:
                    self.model.load_state_dict(params)
                    if self.logger:
                        self.logger.log({"early_stop_epoch": epoch}, kind="info")
                    break
            if self.logger:
                self.logger.log(rec, step=self.state.step, kind="epoch")
            if self.ckpt is not None:
                self.ckpt.save(self.state.step, self.state,
                               extra={"epoch": epoch, "beta_0": beta_0, "beta_1": beta_1})
            if self.plot_dir and epoch % self.plot_every == 0:
                try:
                    self.save_sample_plots(epoch)
                except Exception as e:  # plotting must never kill training
                    if self.logger:
                        self.logger.log({"plot_error": f"{type(e).__name__}: {e}"},
                                        kind="info")
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample_ensemble(self, dataset=None, num_items: int = 3, num_samples: int = 3,
                        seed: int = 0):
        """Prior-ensemble HR fields of the first ``num_items`` items of
        ``dataset`` (by default the validation split, else the training
        split): (hr_pred (B, M, H, W, C), hr, lrinterp, residual ensemble,
        residual targets), the noise from a generator on the model's
        device seeded with ``seed`` (reference
        src/train_prob_unet_model.py:213-305)."""
        ds = next(d for d in (dataset, self.dataset_val, self.dataset_train) if d is not None)
        idx = np.arange(num_items)
        batch = ds.preprocess(torch.from_numpy(ds.get_hr_batch(idx)).to(self.device))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = self.model.sample(batch["inputs"], num_samples, generator=gen)
        lrinterp = lrinterp_from_batch(batch, ds.lowres_scale, ds.interp_mode)
        ist = batch.get("stand_stats")
        if ist is not None:  # the member axis of (B, M, H, W, C) outputs
            ist = {k: v[:, None] for k, v in ist.items()}
        hr_pred = ds.residual_to_hr(out, lrinterp[:, None], ist)
        return hr_pred, batch["hr"], lrinterp, out, batch["targets"]

    def save_sample_plots(self, epoch: int) -> None:
        """The per-epoch ensemble, residual and member-difference figures
        (reference src/main.py:171-203); matplotlib is imported here."""
        from probunet_tpu_torch.utils.plotting import (
            plot_residual_differences,
            plot_residual_sample_batch,
            plot_sample_batch,
        )

        hr_pred, hr, lrinterp, resid, resid_tgt = (
            t.float().cpu().numpy() for t in self.sample_ensemble())
        d = self.plot_dir
        variables = self.cfg.data.variables
        ds = self.dataset_val if self.dataset_val is not None else self.dataset_train
        lat, lon = getattr(ds, "lat", None), getattr(ds, "lon", None)
        plot_sample_batch(hr_pred, hr, lrinterp, variables=variables, lat=lat, lon=lon,
                          save_path=os.path.join(d, f"samples_ep{epoch:03d}.png"))
        plot_residual_sample_batch(resid, resid_tgt, variables=variables, lat=lat, lon=lon,
                                   save_path=os.path.join(d, f"residuals_ep{epoch:03d}.png"))
        plot_residual_differences(resid, variables=variables, lat=lat, lon=lon,
                                  save_path=os.path.join(d, f"residual_diffs_ep{epoch:03d}.png"))
