"""Command-line entry points of the port (port of ``probunet_tpu/cli.py``):

    python -m probunet_tpu_torch train     --preset probunet_multivar_128 --outdir runs/a \
        --set data.packed_train=train.npz data.packed_val=val.npz
    python -m probunet_tpu_torch train-det --preset deterministic_64 --model unet|linearcnn|bcsd
    python -m probunet_tpu_torch pack     --preset probunet_multivar_128 --split test --out test.npz
    python -m probunet_tpu_torch evaluate --preset probunet_multivar_128 --ckpt DIR \
        --set data.packed_test=test.npz
    python -m probunet_tpu_torch extremes --preset probunet_multivar_128 --ckpt DIR --pixels 20,45
    python -m probunet_tpu_torch infer-domain --preset fulldomain_dp8 --ckpt DIR \
        [--quant int8 --quant-skip heads]
    python -m probunet_tpu_torch explore  --preset probunet_multivar_128 --ckpt DIR \
        --set data.packed_test=test.npz [--posterior | --single]
    python -m probunet_tpu_torch sweep    --preset probunet_multivar_128 \
        --grid train.lr=1e-4,3e-4 [--spec sweeps.yaml] [--metric val_crps] [--epochs N]
    BENCH_MODE=train|eval|msssim|ensemble python -m probunet_tpu_torch bench

Config = named preset + dotted overrides (``--set model.compute_dtype=bfloat16``),
with the JAX CLI's flags and defaults. The commands run on the CUDA device;
``PROBUNET_PLATFORM=cpu`` (the JAX CLI's own switch) moves them to the CPU.
Without a card and without that variable they raise.

Where they differ from the JAX CLI:

- **Noise.** Each batch's latent noise comes from :func:`batch_noise`, a
  CPU ``torch.Generator`` seeded from (seed, batch index), handed to
  ``ProbabilisticUNet.sample`` as ``eps``. The ensembles are therefore the
  same on every device and in both of ``evaluate``'s passes, but not the
  JAX CLI's (``jax.random`` draws other numbers).
- **Figures.** A figure that cannot be drawn (no matplotlib on the host)
  is reported as skipped; the numbers are still computed and written.
  ``explore`` also writes the decoded grids it draws as arrays
  (``grids.npz``, and ``prior_sweep.npz`` under ``--single``).
- **Collapse probes.** ``explore``'s probe draws come from a CPU
  generator seeded with 0 (``analysis.latent.collapse_diagnostics``), the
  same on every device, not the JAX CLI's.
- **Checkpoints.** ``--ckpt DIR`` reads the port's ``best_params.pt``
  (``train/checkpoint.py``); a directory without one raises. A model
  trained by the JAX package reaches the port through ``convert.py``.
- **Training noise.** ``train`` and ``train-det`` draw each step's
  dropout seed words and posterior noise from a generator seeded from
  (seed, step) on the device (``train.state.step_generator``), so a resumed
  run redraws the same numbers; they are not the JAX CLI's.
- **int8 serving.** ``--quant int8`` on ``evaluate``, ``extremes`` and
  ``infer-domain`` calibrates per-convolution input scales as the JAX CLI
  does (``ops/quantize.py``; ``--calib-batches``, ``--quant-skip``) and
  serves them through kernel E; the calibration's latent draws come from a
  CPU generator (the scales do not depend on them).
- ``infer-domain`` draws each tile chunk's noise with :func:`batch_noise`
  (seed ``train.seed``, the chunk's index), not the JAX CLI's ``fold_in``.
- ``bench`` runs ``probunet_tpu_torch/bench.py`` (the port's copy of the
  root ``bench.py``: H100 peak, a FLOP count of the plain route, the
  card's name and power limit, peak memory), not the root script.
- **Parallel runs.** ``train --dp N``, ``infer-domain --dp N`` and
  ``evaluate``/``extremes --member-mesh N`` run one process per rank over
  ``torch.distributed`` (NCCL on cards, gloo under
  ``PROBUNET_PLATFORM=cpu``), started by ``torchrun``::

      torchrun --nproc-per-node 4 -m probunet_tpu_torch train --dp 4 ...

  ``--dp`` must equal the world size (``-1`` takes it; ``--dp 1`` without
  ``torchrun`` is a world of one); ``--member-mesh`` must divide it. Only
  rank 0 prints and writes files; the results equal the one-process
  command's (``infer-domain`` at its chunk size rounded up to a multiple of
  the ranks).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import numpy as np
import torch

from probunet_tpu_torch.config import PRESETS, Config, preset
from probunet_tpu_torch.device import resolve_device

EVAL_SEED = 0   # evaluate's noise seed, as the JAX CLI's key(0)


class _PhaseTimer:
    """Wall-clock phase breakdown of a command (the "[timing]" line). On a
    CUDA device each phase ends when the device has finished its work."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = self.last = time.perf_counter()
        self.spans: dict[str, float] = {}

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.spans[name] = self.spans.get(name, 0.0) + now - self.last
        self.last = now

    def report(self) -> None:
        parts = " ".join(f"{k}={v:.1f}s" for k, v in self.spans.items())
        print(f"[timing] {parts} total={time.perf_counter() - self.t0:.1f}s", flush=True)


def cli_device() -> torch.device:
    """The CUDA device, or the CPU under ``PROBUNET_PLATFORM=cpu``."""
    plat = os.environ.get("PROBUNET_PLATFORM", "")
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"PROBUNET_PLATFORM={plat!r}: the port runs on 'cpu' or 'cuda'")
    return resolve_device("cuda")


def batch_noise(seed: int, batch_index: int, members: int, batch_size: int,
                latent_dim: int) -> torch.Tensor:
    """The latent noise ``eps`` (members, batch_size, latent_dim) of batch
    ``batch_index``: standard normal f32 from a CPU ``torch.Generator``
    seeded with ``seed * 2**32 + batch_index``, the same on every device
    and on every pass over the split."""
    gen = torch.Generator().manual_seed(seed * 2 ** 32 + batch_index)
    return torch.randn((members, batch_size, latent_dim), generator=gen)


def _wants_ranks(args) -> bool:
    return bool(getattr(args, "dp", 0)) or (getattr(args, "member_mesh", 0) or 0) > 1


def _data_mesh(args):
    """``--dp N``'s ("data",) mesh over the world (None without ``--dp``):
    N must be the world size (-1 takes it); else raises with the command
    that starts N ranks."""
    if not args.dp:
        return None
    from probunet_tpu_torch.parallel.mesh import make_mesh, world

    _, n = world()
    want = n if args.dp == -1 else args.dp
    if want != n:
        raise ValueError(
            f"--dp {args.dp}: this world has {n} rank(s); start one process per rank, e.g. "
            f"torchrun --nproc-per-node {want} -m probunet_tpu_torch {args.cmd} --dp {want} ...")
    mesh = make_mesh(n_data=n, device=args.device)
    print(f"data-parallel over {mesh.shape}")
    return mesh


def _member_mesh(args):
    """``--member-mesh N``'s ("data", "member") mesh (None for N <= 1): N
    must divide the world size and the data axis the batch size."""
    n_member = getattr(args, "member_mesh", 0) or 0
    if n_member <= 1:
        return None
    from probunet_tpu_torch.parallel.member_parallel import make_member_mesh
    from probunet_tpu_torch.parallel.mesh import world

    _, n = world()
    if n % n_member:
        raise ValueError(f"--member-mesh {n_member} does not divide the world of {n} rank(s); "
                         f"e.g. torchrun --nproc-per-node {n_member} -m probunet_tpu_torch "
                         f"{args.cmd} --member-mesh {n_member} ...")
    if args.batch_size % (n // n_member):
        raise SystemExit(f"--member-mesh {n_member}: --batch-size {args.batch_size} must be a "
                         f"multiple of the data-axis size {n // n_member} (= ranks // member)")
    return make_member_mesh(n_member=n_member, device=args.device)


def _share_scales(scales, mesh):
    """Rank 0's int8 scales tree on every rank of ``mesh`` (None: as is)."""
    if mesh is None:
        return scales
    import torch.distributed as dist

    box = [scales if mesh.is_main else None]
    if mesh.world_size > 1:
        dist.broadcast_object_list(box, src=0, device=mesh.device
                                   if dist.get_backend() == "nccl" else None)
    return box[0]


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


def build_config(args) -> Config:
    cfg = preset(args.preset) if args.preset else Config()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_dict(json.load(f))
    return cfg.override(_parse_overrides(args.set))


def make_datasets(cfg: Config, splits=(0, 1, 2), device: str | torch.device | None = "cuda"):
    """Build the requested dataset splits on ``device``; unrequested entries
    are None (a command that reads one split builds only that one)."""
    from probunet_tpu_torch.data.climex import ClimexDataset

    packed = (cfg.data.packed_train, cfg.data.packed_val,
              cfg.data.packed_test)

    def mk(years, split_idx):
        if split_idx not in splits:
            return None
        return ClimexDataset(
            datadir=cfg.data.datadir or None,
            years=range(*years),
            variables=cfg.data.variables,
            coords=cfg.data.coords,
            pipeline=cfg.data.pipeline,
            lowres_scale=cfg.data.lowres_scale,
            transfo=cfg.data.transfo,
            megafile=cfg.data.megafile,
            interp_mode=cfg.data.interp_mode,
            epsilon=cfg.data.epsilon,
            synthetic=cfg.data.synthetic,
            # distinct synthetic fields per split
            synthetic_seed=cfg.data.synthetic_seed + split_idx,
            standardization=cfg.data.standardization,
            # packed artifacts (from `pack`) win over the other sources
            packed=packed[split_idx] or None,
            device=device,
        )

    return (mk(cfg.data.years_train, 0), mk(cfg.data.years_val, 1),
            mk(cfg.data.years_test, 2))


def make_model(cfg: Config, device: str | torch.device | None = "cuda"):
    """The config's Probabilistic U-Net on ``device``, initialized from a
    generator seeded with ``cfg.train.seed`` (``ProbabilisticUNet.from_config``:
    compute dtype and remat from the config; int8 saved convolution inputs
    under ``PROBUNET_ACT_COMPRESS=int8``, as in the JAX package)."""
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.ops import act_compress

    return ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(cfg.train.seed),
                                         device=device, act_compress=act_compress.enabled())


def make_det_model(cfg: Config, name: str, device: str | torch.device | None = "cuda"):
    """``train-det``'s model ``name`` (``"unet"``: ``UNetAll`` of
    ``cfg.model.unet_type``; ``"linearcnn"``), in f32 as the JAX CLI
    builds it, initialized from a generator seeded with ``cfg.train.seed``,
    on ``device`` (the U-Net's convolutions compressed under
    ``PROBUNET_ACT_COMPRESS=int8``)."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    m = cfg.model
    if name == "linearcnn":
        from probunet_tpu_torch.models.baselines import LinearCNN
        model = LinearCNN(in_channels=m.num_classes, input_channels=m.input_channels,
                          generator=gen)
    else:
        from probunet_tpu_torch.models.unet import UNetAll
        from probunet_tpu_torch.ops import act_compress
        model = UNetAll(m.unet_type, cfg.data.resolution, m.input_channels,
                        cfg.data.lowres_scale, m.num_blocks, m.channel_mult, m.num_classes,
                        model_channels=m.model_channels, dropout=m.dropout, generator=gen,
                        act_compress=act_compress.enabled())
    return model.to(resolve_device(device))


def _load_model(cfg: Config, ckpt: str | None, device: torch.device):
    """The config's model in eval mode on ``device``: the weights of
    ``ckpt``'s best slot, or the seeded initialization without ``ckpt``."""
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.train.checkpoint import CheckpointManager

    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device=device)
    if ckpt:
        params = (CheckpointManager(ckpt).restore_best(device)
                  if os.path.isdir(ckpt) else None)
        if params is None:
            raise FileNotFoundError(
                f"--ckpt {ckpt}: no best_params.pt (the port reads its own torch "
                "checkpoints; JAX params load through probunet_tpu_torch.convert)")
        model.load_state_dict(params)
    return model.eval()


def _sample_hr(model, ds, cfg: Config, idx: np.ndarray, eps: torch.Tensor):
    """(hr_pred (B, M, H, W, C), gt (B, H, W, C)) of the items ``idx`` with
    the prior noise ``eps``, in physical units when the data are stored
    transformed."""
    from probunet_tpu_torch.data.climex import lrinterp_from_batch
    from probunet_tpu_torch.data.transforms import invert_physical_transform

    batch = ds.preprocess(torch.from_numpy(ds.get_hr_batch(idx)).to(ds.device))
    out = model.sample(batch["inputs"], eps.shape[0], eps=eps.to(ds.device))
    lrinterp = lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)
    ist = batch.get("stand_stats")
    if ist is not None:  # the member axis of (B, M, H, W, C) outputs
        ist = {k: v[:, None] for k, v in ist.items()}
    hr_pred = ds.residual_to_hr(out, lrinterp[:, None], ist)
    gt = batch["hr"]
    if cfg.data.transfo:
        # metrics are reported in physical units
        hr_pred = invert_physical_transform(hr_pred, cfg.data.variables)
        gt = invert_physical_transform(gt, cfg.data.variables)
    return hr_pred, gt


def _member_sampler(args, cfg: Config, model, ds, mesh):
    """``--member-mesh N``: (idx, eps) -> (hr_pred, gt) as :func:`_sample_hr`
    returns them, the ensemble generated over ``mesh``
    (``parallel.member_parallel``) and whole on every rank; None without
    a mesh."""
    if mesh is None:
        return None
    from probunet_tpu_torch.data.transforms import invert_physical_transform
    from probunet_tpu_torch.parallel.member_parallel import make_parallel_sample_step

    step = make_parallel_sample_step(model, cfg, mesh, num_samples=args.members)
    stats = ds.device_stats(ds.device)

    def sample_hr(idx, eps):
        hr = torch.from_numpy(ds.get_hr_batch(idx)).to(ds.device)
        hr_pred, gt = step(hr, eps.to(ds.device), stats), hr
        if cfg.data.transfo:
            hr_pred = invert_physical_transform(hr_pred, cfg.data.variables)
            gt = invert_physical_transform(gt, cfg.data.variables)
        return hr_pred, gt

    return sample_hr


def _calibrate(args, model, inputs, where: str):
    """``--quant int8``: the scales tree of the prior-sample path over the
    preprocessed ``inputs``, pruned by ``--quant-skip``, the JAX CLI's lines
    printed; None under ``--quant none``."""
    from probunet_tpu_torch.ops.quantize import calibrate_sample, quant_skip, tree_leaves

    scales = calibrate_sample(model, inputs, num_samples=args.members)
    skip = getattr(args, "quant_skip", None)
    if skip:
        n0 = len(tree_leaves(scales))
        scales = quant_skip(scales, skip)
        print(f"int8 serve: --quant-skip {skip} pruned "
              f"{n0 - len(tree_leaves(scales))} of {n0} scales")
    print(f"int8 serve: calibrated {len(tree_leaves(scales))} conv scales on {len(inputs)} "
          f"{where}")
    return scales


def _serve_scales(args, cfg: Config, model, ds, n_items: int, batch_size: int):
    """``--quant int8``: calibrate the convolutions' input scales on the
    first ``--calib-batches`` batches of the validation split (calibrating
    on the split whose metrics are reported would leak), or of the serve
    split ``ds`` when the validation split cannot be built (said on a
    line); returns the scales tree, None under ``--quant none``."""
    if getattr(args, "quant", "none") != "int8":
        return None
    from probunet_tpu_torch.data.loader import Batches

    calib_ds, split = ds, "serve"
    try:  # built only here: the float path never pays for the validation split
        val = make_datasets(cfg, splits=(1,), device=args.device)[1]
        if val is not None and len(val) > 0:
            calib_ds, split = val, "val"
    except Exception as e:
        print(f"int8 serve: val split unavailable ({e}); calibrating on the serve split")
    n_avail = len(calib_ds) if split == "val" else n_items
    n_calib = max(1, args.calib_batches)
    inputs = []
    for i, idx in enumerate(Batches(n_avail, batch_size)):
        if i >= n_calib:
            break
        hr = torch.from_numpy(calib_ds.get_hr_batch(idx)).to(args.device)
        inputs.append(calib_ds.preprocess(hr)["inputs"])
    return _calibrate(args, model, inputs, f"{split}-split batches")


# ---------------------------------------------------------------------------
# Subcommands
# ---------------------------------------------------------------------------

def cmd_train(args):
    """Probabilistic U-Net ELBO training (the reference's src/main.py
    script): ``config.json``, the train and validation splits, ``Trainer``
    with checkpoints under ``ckpt/`` (``--resume`` restores the latest
    one's full state and continues from its step; the epochs count from 1
    again, as in the JAX CLI), ``losses.pkl``, the residual contribution
    of a prior ensemble on the validation split, the loss curves (figures
    guarded) and the ``{"final": ...}`` line. Returns (that line's object
    with the residual contribution, the phase times in seconds)."""
    import pickle

    from probunet_tpu_torch.evals import residual_contribution
    from probunet_tpu_torch.train.checkpoint import CheckpointManager
    from probunet_tpu_torch.train.logging import MetricLogger
    from probunet_tpu_torch.train.loop import Trainer

    timer = _PhaseTimer(args.device)
    cfg = build_config(args)
    mesh = _data_mesh(args)
    main = mesh is None or mesh.is_main
    os.makedirs(args.outdir, exist_ok=True)
    if main:
        with open(os.path.join(args.outdir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    ds_train, ds_val, _ = make_datasets(cfg, splits=(0, 1), device=args.device)
    timer.mark("dataset")
    model = make_model(cfg, args.device)
    logger = MetricLogger(logdir=args.outdir, use_wandb=args.wandb) if main else None
    ckpt = CheckpointManager(os.path.join(os.path.abspath(args.outdir), "ckpt"))
    trainer = Trainer(cfg, model, ds_train, ds_val, logger=logger, checkpoint_manager=ckpt,
                      plot_dir=args.outdir if args.plot_every else None,
                      plot_every=args.plot_every or 1, mesh=mesh, device=args.device)
    if args.resume:
        latest = ckpt.latest_step()
        if latest is not None:
            trainer.state, _ = ckpt.restore(trainer.state, latest)
            print(f"resumed from step {latest}")
        else:
            print("no checkpoint found; training from scratch")
    timer.mark("init")
    history = trainer.fit()
    timer.mark("fit")
    if main:
        with open(os.path.join(args.outdir, "losses.pkl"), "wb") as f:
            pickle.dump(history, f)
    # improvement over plain interpolation (reference
    # src/train_prob_unet_model.py:307-349)
    ds = ds_val if ds_val is not None else ds_train
    hr_pred, hr, lrinterp, *_ = trainer.sample_ensemble(num_items=min(32, len(ds)),
                                                        num_samples=4)
    contrib = residual_contribution(hr_pred, lrinterp, hr)
    print(json.dumps({"residual_contribution": contrib}))
    timer.mark("contribution")
    if main:
        try:
            from probunet_tpu_torch.utils.plotting import plot_loss_curves
            plot_loss_curves(history, save_path=os.path.join(args.outdir, "loss_curves.png"))
        except Exception as e:  # the figure only: the numbers are written
            print(f"plotting skipped: {type(e).__name__}: {e}")
        logger.close()
    timer.mark("figures")
    out = {"final": {k: (v[-1] if v else None) for k, v in history.items()}}
    print(json.dumps(out))
    timer.report()
    return {**out, "residual_contribution": contrib, "steps": trainer.state.step}, timer.spans


def _chunked_lrinterp(ds, device: torch.device, days: int = 512) -> torch.Tensor:
    """``preprocess``'s lrinterp of the whole split, ``days`` at a time (each
    item's interpolation is its own, so the numbers are those of one call
    over the split)."""
    parts = [ds.preprocess(torch.from_numpy(ds.hr[s: s + days]).to(device))["lrinterp"]
             for s in range(0, len(ds), days)]
    return torch.cat(parts)


def cmd_train_det(args):
    """The deterministic baselines (the reference's src/baseline/main.py):
    ``--model unet`` (``UNetAll`` of ``model.unet_type``) or ``linearcnn``
    trained with the MSE step for ``train.num_epochs`` epochs (Batches and
    the prefetch, one ``epoch N: mse=...`` line each), then the
    per-variable MAE in physical units on the first 512 test days,
    drop-last batches; ``bcsd`` fits and scores whole splits (whole years
    needed). Returns (the printed JSON object, the phase times)."""
    from probunet_tpu_torch.data.climex import lrinterp_from_batch
    from probunet_tpu_torch.data.loader import Batches, prefetch_to_device
    from probunet_tpu_torch.data.transforms import invert_physical_transform
    from probunet_tpu_torch.train.loop import make_deterministic_train_step
    from probunet_tpu_torch.train.state import create_train_state

    timer = _PhaseTimer(args.device)
    dev = args.device
    cfg = build_config(args)
    os.makedirs(args.outdir, exist_ok=True)
    ds_train, _, ds_test = make_datasets(cfg, splits=(0, 2), device=dev)
    timer.mark("dataset")

    if args.model == "bcsd":
        from probunet_tpu_torch.models.baselines import bcsd

        with torch.no_grad():
            test_hr = torch.from_numpy(ds_test.hr).to(dev)
            pred = bcsd(torch.from_numpy(ds_train.hr).to(dev), _chunked_lrinterp(ds_train, dev),
                        _chunked_lrinterp(ds_test, dev))
            mae = float(torch.abs(pred - test_hr[: pred.shape[0]]).mean())
        out = {"model": "bcsd", "test_mae": mae}
        print(json.dumps(out))
        timer.mark("bcsd")
        timer.report()
        return out, timer.spans

    model = make_det_model(cfg, args.model, dev)
    state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device=dev)
    step = make_deterministic_train_step(model, cfg)
    stats = ds_train.device_stats(dev)
    timer.mark("init")
    for epoch in range(1, cfg.train.num_epochs + 1):
        batches = Batches(len(ds_train), cfg.train.batch_size, shuffle=True,
                          seed=cfg.train.seed + epoch)
        losses = []
        hrs = (ds_train.get_hr_batch(i) for i in batches)
        for hr in prefetch_to_device(hrs, device=dev):
            state, metrics = step(state, hr, stats)
            losses.append(metrics["loss"])
        print(f"epoch {epoch}: mse={float(torch.stack(losses).mean()):.5f}")
    timer.mark("fit")

    # the real-units per-variable MAE on the test split: HR = lrinterp +
    # unstandardized residual, the physical transforms inverted (reference
    # trainmodel.py:237-305 and baseline/main.py:113-117)
    @torch.no_grad()
    def mae_per_var(hr_batch):
        batch = ds_test.preprocess(hr_batch)
        pred = model(batch["inputs"], train=False)
        hr_pred = ds_test.residual_to_hr(
            pred, lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode),
            batch.get("stand_stats"))
        gt = batch["hr"]
        if cfg.data.transfo:
            hr_pred = invert_physical_transform(hr_pred, cfg.data.variables)
            gt = invert_physical_transform(gt, cfg.data.variables)
        err = torch.abs(hr_pred - gt)
        return err.mean(dim=tuple(range(err.dim() - 1)))             # (C,)

    batches = Batches(min(len(ds_test), 512), cfg.train.batch_size)
    maes = [mae_per_var(hr) for hr in prefetch_to_device(
        (ds_test.get_hr_batch(i) for i in batches), device=dev)]
    mae = torch.stack(maes).mean(dim=0).cpu().numpy()
    out = {"model": args.model, "epochs": cfg.train.num_epochs,
           "test_mae_real_units": dict(zip(cfg.data.variables, mae.tolist()))}
    print(json.dumps(out))
    timer.mark("test_mae")
    timer.report()
    return out, timer.spans


def cmd_explore(args):
    """Latent exploration of a trained model over the test split (the
    reference's src/latent_exploration*.py): the prior (or, with
    ``--posterior``, posterior) means of the first ``--max-items`` items,
    their PCA, the ten collapse probes over ``--probe-contexts`` items
    (``summary.txt``, ``pca_artifacts.pkl``), the PC1 x PC2 joint-marginal
    figure, and the decile and sigma grids (7x7, 10x10 with
    ``--posterior``) decoded against item 0's frozen features in residual
    and HR space (figures and ``grids.npz``). ``--single``: the
    single-sample prior sweep of the top-2 sigma dims instead (four
    figures, ``prior_sweep.npz``, the ``{"dims": [...]}`` line). Returns
    (a summary object, the phase times in seconds)."""
    from probunet_tpu_torch.analysis import (
        LatentPCA, collapse_diagnostics, collect_latents, decode_latent_grid,
        format_summary, pc_grid_deciles, pc_grid_sigma, single_prior_sweep,
    )
    from probunet_tpu_torch.analysis.latent import grid_to_z, save_artifacts
    from probunet_tpu_torch.data.climex import lrinterp_from_batch

    timer = _PhaseTimer(args.device)
    cfg = build_config(args)
    os.makedirs(args.outdir, exist_ok=True)
    _, _, ds_test = make_datasets(cfg, splits=(2,), device=args.device)
    timer.mark("dataset")
    model = _load_model(cfg, args.ckpt, args.device)
    timer.mark("init")

    def outpath(name):
        return os.path.join(args.outdir, name)

    def item0():
        """(item 0's batch, its lrinterp) for the HR-space grids."""
        batch = ds_test.preprocess(torch.from_numpy(
            ds_test.get_hr_batch(np.array([0]))).to(args.device))
        return batch, lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)

    def to_hr(residual: np.ndarray, lrinterp: torch.Tensor) -> np.ndarray:
        return ds_test.residual_to_hr(torch.from_numpy(residual).to(args.device),
                                      lrinterp).cpu().numpy()

    def figures(draw) -> None:
        try:
            draw()
        except Exception as e:  # figures only: the numbers are written
            print(f"figures skipped: {type(e).__name__}: {e}")

    if args.single:
        sweep = single_prior_sweep(model, ds_test, n=6, span=6.0)
        _, lrinterp0 = item0()
        dec = sweep["decoded"]
        n = dec.shape[0]
        hr_grid = to_hr(dec.reshape(n * n, *dec.shape[2:]), lrinterp0).reshape(dec.shape)
        hr_center = to_hr(sweep["center"][None], lrinterp0)[0]
        np.savez(outpath("prior_sweep.npz"), dims=sweep["dims"], decoded=dec,
                 hr=hr_grid, hr_center=hr_center)
        timer.mark("sweep")
        dims = sweep["dims"]

        def draw():
            from probunet_tpu_torch.utils.plotting import plot_latent_grid
            plot_latent_grid(dec, title=f"prior sweep dims {dims}",
                             save_path=outpath("prior_sweep.png"))
            plot_latent_grid(hr_grid, symmetric=False, cmap="viridis",
                             title=f"prior sweep HR (global norm) dims {dims}",
                             save_path=outpath("prior_sweep_hr.png"))
            plot_latent_grid(hr_grid, symmetric=False, cmap="viridis", per_panel_norm=True,
                             title=f"prior sweep HR (per-panel norm) dims {dims}",
                             save_path=outpath("prior_sweep_hr_perpanel.png"))
            plot_latent_grid(hr_grid - hr_center[None, None],
                             title=f"prior sweep HR delta-to-center dims {dims}",
                             save_path=outpath("prior_sweep_delta.png"))

        figures(draw)
        timer.mark("figures")
        out = {"dims": np.asarray(dims).tolist()}
        print(json.dumps(out))
        timer.report()
        return out, timer.spans

    lat = collect_latents(model, ds_test, use_posterior=args.posterior,
                          max_items=args.max_items)
    pca = LatentPCA.fit(lat["mu"])
    scores = pca.transform(lat["mu"])
    timer.mark("latents")
    diag = collapse_diagnostics(model, ds_test, max_items=args.max_items,
                                n_contexts=args.probe_contexts)
    report = format_summary(diag)
    print(report)
    with open(outpath("summary.txt"), "w") as f:
        f.write(report + "\n")
    save_artifacts(outpath("pca_artifacts.pkl"), pca, lat, diag)
    timer.mark("diagnostics")

    # decile and sigma grids decoded against item 0's frozen features, in
    # residual space and in HR space
    batch, lrinterp0 = item0()
    with torch.no_grad():
        feats, _, _ = model.encode(batch["inputs"])
    n = 10 if args.posterior else 7
    grids = {}
    for name, grid in (("decile", pc_grid_deciles(scores, n)),
                       ("sigma", pc_grid_sigma(scores, n))):
        dec = decode_latent_grid(model, feats, grid_to_z(pca, grid, fill_scores=scores))
        h, w, k = dec.shape[1:]
        grids[name] = dec.reshape(n, n, h, w, k)
        grids[f"{name}_hr"] = to_hr(dec, lrinterp0).reshape(n, n, h, w, k)
    np.savez(outpath("grids.npz"), **grids)
    timer.mark("grids")

    def draw():
        from probunet_tpu_torch.utils.plotting import (
            plot_latent_grid, plot_latent_joint_marginal)
        if scores.shape[1] >= 2:
            plot_latent_joint_marginal(
                scores, pca.explained_variance_ratio,
                title_prefix=("Latent space (posterior)" if args.posterior
                              else "Latent space (prior)"),
                save_path=outpath("latent_joint_marginal.png"))
        for name in ("decile", "sigma"):
            plot_latent_grid(grids[name], title=f"{name} grid (PC1 x PC2)",
                             save_path=outpath(f"grid_{name}.png"))
            plot_latent_grid(grids[f"{name}_hr"], symmetric=False, cmap="viridis",
                             title=f"{name} grid, HR space (PC1 x PC2)",
                             save_path=outpath(f"grid_{name}_hr.png"))

    figures(draw)
    timer.mark("figures")
    timer.report()
    out = {"items": int(lat["mu"].shape[0]), "latent_dim": int(diag["latent_dim"]),
           "n_contexts": diag["n_contexts"], "collapsed": diag["collapsed"],
           "explained_variance_ratio": pca.explained_variance_ratio.tolist()}
    return out, timer.spans


def cmd_evaluate(args):
    """Ensemble test-set evaluation: CRPS / MAE / spread / PSD, streamed:
    every metric is reduced on the device per batch and only (B, C) and
    (k, C) partials reach the host. With ``--outdir`` a second pass over
    the same ensembles fills the pooled-pixel histograms, whose bins are
    known only after the first. Returns (the printed JSON object, the
    phase times in seconds)."""
    from probunet_tpu_torch.data.loader import Batches
    from probunet_tpu_torch.evals import EvalAccumulator
    from probunet_tpu_torch.ops.quantize import attached

    timer = _PhaseTimer(args.device)
    cfg = build_config(args)
    mesh = _member_mesh(args)
    main = mesh is None or mesh.is_main
    _, _, ds_test = make_datasets(cfg, splits=(2,), device=args.device)
    timer.mark("dataset")
    model = _load_model(cfg, args.ckpt, args.device)
    timer.mark("init")

    m = args.members
    n_items = min(len(ds_test), args.max_items or len(ds_test))
    with torch.inference_mode():
        scales = (_serve_scales(args, cfg, model, ds_test, n_items, args.batch_size)
                  if main else None)
        scales = _share_scales(scales, mesh)
    if scales is not None:
        timer.mark("calib")
    sample = (_member_sampler(args, cfg, model, ds_test, mesh)
              or (lambda idx, eps: _sample_hr(model, ds_test, cfg, idx, eps)))

    def ensembles():
        for i, idx in enumerate(Batches(n_items, args.batch_size)):
            yield sample(idx, batch_noise(EVAL_SEED, i, m, len(idx), cfg.model.latent_dim))

    acc = EvalAccumulator()
    with torch.inference_mode(), attached(model, scales):
        for e, g in ensembles():   # every rank generates; rank 0 scores
            if main:
                acc.update(e, g)
        timer.mark("metric_loop")
        if args.outdir:
            for e, g in ensembles():
                if main:
                    acc.update_hist(e, g)
            timer.mark("hist_loop")
    if not main:
        return None, timer.spans
    res = acc.result()

    out = {
        "members": m,
        "items": res["items"],
        "crps_mean": res["crps"]["mean"].tolist(),
        "crps_std": res["crps"]["std"].tolist(),
        "mae_mean": res["mae"]["mean"].tolist(),
        "spread": res["spread"].tolist(),
    }
    print(json.dumps(out))
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        with open(os.path.join(args.outdir, "eval.json"), "w") as f:
            json.dump(out, f, indent=2)
        hist = {
            var: {"bins": res["hist"]["centers"][ci],
                  "gt": res["hist"]["gt_log"][ci],
                  "model": res["hist"]["model_log"][ci]}
            for ci, var in enumerate(cfg.data.variables)
        }
        try:
            from probunet_tpu_torch.utils.plotting import plot_histograms, plot_psd
            plot_psd({"gt": res["psd_gt"], "model": res["psd_model"]},
                     variables=cfg.data.variables,
                     save_path=os.path.join(args.outdir, "psd.png"))
            plot_histograms(hist, save_path=os.path.join(args.outdir, "histograms.png"))
        except Exception as e:  # figures only: the numbers above are written
            print(f"figures skipped: {type(e).__name__}: {e}")
        timer.mark("figures")
    timer.report()
    return out, timer.spans


def cmd_extremes(args):
    """Observed-vs-model return levels, end to end: checkpoint -> batched
    daily per-pixel ensembles over the test years (only the requested
    pixels reach the host) -> annual block maxima -> GEV fit + parametric
    bootstrap CI -> ``extremes.json`` and the curves. Returns (the printed
    JSON object, the phase times in seconds)."""
    from probunet_tpu_torch.data.loader import Batches
    from probunet_tpu_torch.evals import model_ensemble_analysis, return_level_analysis
    from probunet_tpu_torch.ops.quantize import attached

    timer = _PhaseTimer(args.device)
    cfg = build_config(args)
    mesh = _member_mesh(args)
    main = mesh is None or mesh.is_main
    os.makedirs(args.outdir, exist_ok=True)
    _, _, ds_test = make_datasets(cfg, splits=(2,), device=args.device)
    timer.mark("dataset")
    model = _load_model(cfg, args.ckpt, args.device)
    timer.mark("init")

    pixels = [tuple(int(v) for v in p.split(",")) for p in args.pixels]
    h, w = ds_test.hr.shape[1:3]
    outside = [p for p in pixels if not (0 <= p[0] < h and 0 <= p[1] < w)]
    if outside:  # a device gather would not report them
        raise ValueError(f"--pixels {outside} outside the {h}x{w} grid")
    var_idx = list(cfg.data.variables).index(args.var)
    ys = torch.tensor([p[0] for p in pixels], device=args.device)
    xs = torch.tensor([p[1] for p in pixels], device=args.device)
    m = args.members

    days = len(ds_test) if not args.days else min(args.days, len(ds_test))
    with torch.inference_mode():
        scales = (_serve_scales(args, cfg, model, ds_test, days, args.batch_size)
                  if main else None)
        scales = _share_scales(scales, mesh)
    if scales is not None:
        timer.mark("calib")
    sample = (_member_sampler(args, cfg, model, ds_test, mesh)
              or (lambda idx, eps: _sample_hr(model, ds_test, cfg, idx, eps)))
    model_vals, gt_vals = [], []
    with torch.inference_mode(), attached(model, scales):
        for i, idx in enumerate(Batches(days, args.batch_size)):
            e, g = sample(idx, batch_noise(cfg.train.seed, i, m, len(idx), cfg.model.latent_dim))
            model_vals.append(e[:, :, ys, xs, var_idx].cpu().numpy())
            gt_vals.append(g[:, ys, xs, var_idx].cpu().numpy())
    if not main:   # every rank generated; rank 0 fits and writes
        return None, timer.spans
    model_series = np.concatenate(model_vals)  # (T, M, P)
    gt_series = np.concatenate(gt_vals)        # (T, P)
    timer.mark("sample_loop")

    periods = tuple(args.return_periods)
    results = {}
    for pi, (py, px) in enumerate(pixels):
        obs = return_level_analysis(
            gt_series[:, pi], periods, args.days_per_year,
            n_boot=args.n_boot, seed=cfg.train.seed,
        )
        mod = model_ensemble_analysis(
            model_series[:, :, pi], periods, args.days_per_year,
            n_boot=args.n_boot, seed=cfg.train.seed,
        )
        name = f"pixel_{py}_{px}"
        results[name] = {
            "pixel": [py, px],
            "observed": {
                "gev_fit": list(obs["fit"]),
                "return_levels": obs["return_levels"].tolist(),
                "ci_lower": obs["bootstrap"]["lower"].tolist(),
                "ci_upper": obs["bootstrap"]["upper"].tolist(),
                "bootstrap_valid": obs["bootstrap"]["n_valid"],
                "bootstrap_failed": obs["bootstrap"]["n_failed"],
                # raw annual maxima (n_years,): refit on the host without
                # sampling the split again
                "block_maxima": obs["block_maxima"].tolist(),
            },
            "model": {
                "gev_fit": list(mod["fit"]),
                "return_levels": mod["return_levels"].tolist(),
                "ci_lower": mod["bootstrap"]["lower"].tolist(),
                "ci_upper": mod["bootstrap"]["upper"].tolist(),
                "bootstrap_valid": mod["bootstrap"]["n_valid"],
                "bootstrap_failed": mod["bootstrap"]["n_failed"],
                # where the model's empirical maxima top out
                "empirical_plateau": float(mod["empirical_levels"].max()),
                # (n_years, M) per-member annual maxima, pooled for the fit
                "block_maxima": mod["block_maxima"].tolist(),
            },
        }
        try:
            from probunet_tpu_torch.utils.plotting import plot_return_levels
            plot_return_levels(
                mod, observed_analysis=obs, label="model",
                save_path=os.path.join(args.outdir, f"return_levels_{name}.png"),
            )
        except Exception as e:  # the figure only: the numbers are kept
            print(f"plotting skipped for {name}: {type(e).__name__}: {e}")

    timer.mark("gev_fits")
    # the days served: Batches drops the ragged tail batch (static batch
    # shape), so a 4,380-day split at bs=32 serves 136 x 32 = 4,352 days
    out = {"variable": args.var, "members": m,
           "days": int(model_series.shape[0]),
           "days_requested": int(days),
           "days_per_year": args.days_per_year,
           "return_periods": list(periods), "pixels": results}
    with open(os.path.join(args.outdir, "extremes.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    timer.report()
    return out, timer.spans


def cmd_infer_domain(args):
    """Full-domain tiled ensemble inference (BASELINE config 5, one device):
    the domain (``--domain``, 280 for ClimEx; synthetic unless
    ``data.datadir``) edge-padded to a pooling multiple, cut into tiles of
    the model's window aligned to the pooling grid (overlap ``--overlap``),
    every (day, tile) pair a batch row, ``--batch-tiles`` a chunk, the
    statistics sliced per tile from the domain's; each tile's HR ensemble
    (noise from :func:`batch_noise` per chunk) is stitched with cosine-ramp
    blending, cropped, brought to physical units and scored (CRPS, MAE).
    ``--quant int8`` calibrates on the first ``--calib-batches`` chunks
    (the model serves at tile resolution; there is no held-out tile
    source). Writes ``infer_domain.json`` and the guarded figure. Returns
    (the printed JSON object, the phase times in seconds: ``sample`` holds
    the tiles' sampling and their stitch, :func:`tiled_ensemble`).

    ``--dp N``: each chunk (its size rounded up to a multiple of N, as the
    JAX CLI rounds it) is split over the ranks, its noise drawn whole and
    sliced; rank 0 calibrates (``--quant int8``) and writes. The result
    equals the one-process command's at the rounded chunk size."""
    from probunet_tpu_torch.data.climex import (
        ClimexDataset, Standardization, lrinterp_from_batch, preprocess_batch, residual_to_hr)
    from probunet_tpu_torch.evals import compute_mae, crps_over_groundtruth
    from probunet_tpu_torch.ops.quantize import attached
    from probunet_tpu_torch.parallel.spatial import extract_tiles, tile_positions, tiled_ensemble

    timer = _PhaseTimer(args.device)
    dev = args.device
    cfg = build_config(args)
    mesh = _data_mesh(args)
    main = mesh is None or mesh.is_main
    d = cfg.data
    k = d.lowres_scale
    tile = d.resolution[0]
    dom = args.domain
    os.makedirs(args.outdir, exist_ok=True)
    # the dataset edge-pads the domain to a pooling multiple (280 is not
    # divisible by 16): inference runs on the padded grid, the stitched
    # result is cropped back to `dom`
    ds = ClimexDataset(datadir=d.datadir or None, years=range(*d.years_test),
                       variables=d.variables, coords=(0, dom, 0, dom), pipeline=d.pipeline,
                       lowres_scale=k, transfo=d.transfo, interp_mode=d.interp_mode,
                       synthetic=d.synthetic or not d.datadir, pad_to_multiple=True, device=dev)
    days = min(args.days, len(ds))
    hr_days = torch.from_numpy(ds.get_hr_batch(np.arange(days))).to(dev)
    dom_pad = hr_days.shape[1]
    timer.mark("dataset")
    model = _load_model(cfg, args.ckpt, dev)
    timer.mark("init")

    positions = tile_positions(dom_pad, dom_pad, tile, args.overlap, align=k)
    ntiles = len(positions)
    g = ds.device_stats(dev)

    def stat_tiles(arr, scale):
        if arr is None:
            return None
        s = torch.stack([arr[y // scale:(y + tile) // scale, x // scale:(x + tile) // scale]
                         for (y, x) in positions])
        return s.repeat(days, 1, 1, 1)            # day-major, as the tiles

    stats_t = Standardization(*(stat_tiles(a, k if name.startswith("lr") else 1)
                                for name, a in zip(Standardization._fields, g)))

    def chunk_stats(i, n):
        return Standardization(*(None if a is None else a[i:i + n] for a in stats_t))

    def preprocess(tiles, i):
        return preprocess_batch(tiles, chunk_stats(i, tiles.shape[0]), d.pipeline, k,
                                d.interp_mode, d.epsilon, d.standardization)

    m = args.members
    bs = args.batch_tiles
    if mesh is not None:   # a chunk divides over the ranks
        bs = -(-bs // mesh.world_size) * mesh.world_size
    n_tiles = days * ntiles
    scales = None
    if getattr(args, "quant", "none") == "int8" and main:
        with torch.inference_mode():
            n_calib = min(max(1, args.calib_batches) * bs, days * ntiles)
            first, _ = extract_tiles(hr_days[:-(-n_calib // ntiles)], tile, args.overlap,
                                     align=k)
            inputs = [preprocess(first[i:min(i + bs, n_calib)], i)["inputs"]
                      for i in range(0, n_calib, bs)]
            scales = _calibrate(args, model, inputs, "tile chunks")
            del first, inputs
    scales = _share_scales(scales, mesh)
    if scales is not None:
        timer.mark("calib")

    def sample_hr(tiles, i, rows=None):
        """The chunk from tile i's ensemble, or its tiles ``rows`` (a rank's
        share), the chunk's noise drawn whole."""
        n = min(bs, n_tiles - i)
        eps = batch_noise(cfg.train.seed, i // bs, m, n, cfg.model.latent_dim)
        st = chunk_stats(i, n)
        if rows is not None:
            at = torch.from_numpy(rows).to(dev)
            eps = eps[:, torch.from_numpy(rows)]
            st = Standardization(*(None if a is None else a[at] for a in st))
        batch = preprocess_batch(tiles, st, d.pipeline, k, d.interp_mode, d.epsilon,
                                 d.standardization)
        out = model.sample(batch["inputs"], m, eps=eps.to(dev))
        st_b = Standardization(*(None if a is None else a[:, None] for a in st))
        ist = batch.get("stand_stats")
        if ist is not None:                           # the member axis
            ist = {key: v[:, None] for key, v in ist.items()}
        lrinterp = lrinterp_from_batch(batch, k, d.interp_mode)
        return residual_to_hr(out, lrinterp[:, None], st_b, d.pipeline, d.epsilon,
                              d.standardization, ist)

    with torch.inference_mode(), attached(model, scales):
        full = tiled_ensemble(sample_hr, hr_days, tile, args.overlap, bs, align=k, mesh=mesh)
        timer.mark("sample")
        full = full[:, :, :dom, :dom]                 # (T, M, H, W, C), padding cropped
        gt = hr_days[:, :dom, :dom]
        if d.transfo:
            from probunet_tpu_torch.data.transforms import invert_physical_transform
            full = invert_physical_transform(full, d.variables)
            gt = invert_physical_transform(gt, d.variables)
        crps = crps_over_groundtruth(full, gt)
        mae = compute_mae(full, gt)
        result = {"domain": dom, "days": days, "tiles_per_day": ntiles, "members": m,
                  "crps_mean": crps["mean"].cpu().numpy().tolist(),
                  "mae_mean": mae["mean"].cpu().numpy().tolist()}
    timer.mark("metrics")
    if not main:
        return None, timer.spans
    print(json.dumps(result))
    with open(os.path.join(args.outdir, "infer_domain.json"), "w") as f:
        json.dump(result, f, indent=2)
    try:
        from probunet_tpu_torch.utils.plotting import plot_sample_batch
        plot_sample_batch(full[:1, :3].cpu().numpy(), gt[:1].cpu().numpy(),
                          variables=d.variables,
                          save_path=os.path.join(args.outdir, "domain.png"))
    except Exception as e:  # the figure only: the numbers are written
        print(f"plotting skipped: {type(e).__name__}: {e}")
    timer.mark("figures")
    timer.report()
    return result, timer.spans


def cmd_pack(args):
    """One-time conversion of a split to the packed artifact (raw physical
    fields; the transforms apply when it is loaded)."""
    from probunet_tpu_torch.data.climex import ClimexDataset, save_packed

    cfg = build_config(args)
    years = {"train": cfg.data.years_train, "val": cfg.data.years_val,
             "test": cfg.data.years_test}[args.split]
    ds = ClimexDataset(
        datadir=cfg.data.datadir or None,
        years=range(*years),
        variables=cfg.data.variables,
        coords=cfg.data.coords,
        pipeline=cfg.data.pipeline,
        lowres_scale=cfg.data.lowres_scale,
        transfo=False,
        megafile=cfg.data.megafile,
        synthetic=cfg.data.synthetic,
        device=args.device,
    )
    save_packed(args.out, ds.hr, ds.timestamps, ds.timestamps_float)
    out = {"packed": args.out, "shape": list(ds.hr.shape)}
    print(json.dumps(out))
    return out


# the reference's flat sweep-parameter names (sweeps.yaml) -> dotted keys
SWEEP_ALIASES = {"batch_size": "train.batch_size", "lr": "train.lr",
                 "num_epochs": "train.num_epochs", "ensemble_size": "train.ensemble_size",
                 "latent_dim": "model.latent_dim"}


def _is_json(s: str) -> bool:
    try:
        json.loads(s)
        return True
    except json.JSONDecodeError:
        return False


def sweep_spec(args) -> dict:
    """The sweep's {dotted.key: [values]}: ``--spec`` FILE (JSON, or YAML:
    the plain form or wandb's ``{parameters: {key: {values: [...]}}}``
    schema of the reference's sweeps.yaml) or the inline ``--grid`` pairs
    ``key=v1,v2,...`` (each value JSON where it parses, else a string)."""
    if not args.spec:
        spec = {}
        for pair in args.grid or []:
            key, _, vals = pair.partition("=")
            spec[key] = [json.loads(v) if _is_json(v) else v for v in vals.split(",")]
        return spec
    with open(args.spec) as f:
        if not args.spec.endswith((".yaml", ".yml")):
            return json.load(f)
        try:
            import yaml
        except ImportError:
            raise SystemExit(f"sweep --spec {args.spec}: reading YAML needs PyYAML, which "
                             "is not installed; give the spec as JSON or --grid") from None
        raw = yaml.safe_load(f)
    if "parameters" in raw:
        return {SWEEP_ALIASES.get(k, k): v["values"] for k, v in raw["parameters"].items()}
    return raw


def cmd_sweep(args):
    """Hyperparameter grid sweep (reference sweeps.yaml:1-14 semantics: a
    grid over dotted config keys, ranked by the final validation metric):
    one ``Trainer`` run per point on the command's device, ``sweep.json``
    (the points best first) and the ``{"best", "points"}`` line. Returns
    the summary list."""
    from probunet_tpu_torch.sweep import run_sweep

    cfg = build_config(args)
    spec = sweep_spec(args)
    if not spec:
        raise SystemExit("sweep needs --spec FILE or --grid key=v1,v2,...")
    results = run_sweep(cfg, spec, metric=args.metric, num_epochs=args.epochs or None,
                        device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    summary = [{"overrides": r["overrides"], args.metric: r[args.metric]} for r in results]
    with open(os.path.join(args.outdir, "sweep.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"best": summary[0], "points": len(summary)}))
    return summary


def cmd_bench(args):
    """The port's benchmark (``probunet_tpu_torch/bench.py``, env knobs
    ``BENCH_*``); returns its JSON line as a dict."""
    from probunet_tpu_torch import bench

    return bench.main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="probunet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--preset", choices=PRESETS, default=None)
        sp.add_argument("--config", default=None, help="config JSON path")
        sp.add_argument("--set", nargs="*", default=[],
                        help="dotted overrides key=value")
        sp.add_argument("--outdir", default="results")

    def serve_flags(sp):
        sp.add_argument("--ckpt", default=None,
                        help="checkpoint directory holding best_params.pt")
        sp.add_argument("--member-mesh", type=int, default=0, metavar="N",
                        help="ensemble members over N ranks (N divides the world "
                             "size of torchrun; the rest split the batch)")
        quant_flags(sp)

    def quant_flags(sp):
        sp.add_argument("--quant", choices=("none", "int8"), default="none",
                        help="serve the ensemble with int8 convs (kernel E)")
        sp.add_argument("--calib-batches", type=int, default=4,
                        help="serve batches the int8 calibration pass sees")
        sp.add_argument("--quant-skip", nargs="*", default=None,
                        help="regexes of conv module paths kept in float under "
                             "--quant int8; alias 'heads' = the latent heads")

    sp = sub.add_parser("train", help="probabilistic U-Net ELBO training")
    common(sp)
    sp.add_argument("--wandb", action="store_true",
                    help="also log to wandb when it is installed (else skipped quietly)")
    sp.add_argument("--resume", action="store_true",
                    help="resume the full train state from the latest checkpoint")
    sp.add_argument("--plot-every", type=int, default=0,
                    help="save ensemble/residual figures every N epochs (0 = off)")
    sp.add_argument("--dp", type=int, default=0,
                    help="data-parallel over N ranks, the world size of torchrun "
                         "(-1: the world size)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("train-det", help="deterministic baselines")
    common(sp)
    sp.add_argument("--model", default="unet", choices=("unet", "linearcnn", "bcsd"))
    sp.set_defaults(fn=cmd_train_det)

    sp = sub.add_parser("explore", help="latent exploration")
    common(sp)
    sp.add_argument("--ckpt", default=None,
                    help="checkpoint directory holding best_params.pt")
    sp.add_argument("--posterior", action="store_true")
    sp.add_argument("--single", action="store_true")
    sp.add_argument("--max-items", type=int, default=512)
    sp.add_argument("--probe-contexts", type=int, default=32,
                    help="items the collapse probes 5-10 aggregate over "
                         "(1 = single-context fast path)")
    sp.set_defaults(fn=cmd_explore)

    sp = sub.add_parser("evaluate", help="ensemble CRPS/MAE/PSD eval")
    common(sp)
    serve_flags(sp)
    sp.add_argument("--members", type=int, default=16)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--max-items", type=int, default=None)
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("infer-domain", help="full-domain tiled ensemble inference")
    common(sp)
    sp.add_argument("--ckpt", default=None,
                    help="checkpoint directory holding best_params.pt")
    sp.add_argument("--domain", type=int, default=280)
    sp.add_argument("--days", type=int, default=4)
    sp.add_argument("--members", type=int, default=8)
    sp.add_argument("--overlap", type=int, default=16)
    sp.add_argument("--batch-tiles", type=int, default=16)
    sp.add_argument("--dp", type=int, default=0,
                    help="tile chunks over N ranks, the world size of torchrun "
                         "(-1: the world size)")
    quant_flags(sp)
    sp.set_defaults(fn=cmd_infer_domain)

    sp = sub.add_parser("extremes",
                        help="observed-vs-model GEV return-level comparison")
    common(sp)
    serve_flags(sp)
    sp.add_argument("--var", default="pr")
    sp.add_argument("--pixels", nargs="+", default=["20,45"],
                    help="pixel coords y,x (repeatable)")
    sp.add_argument("--members", type=int, default=8)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--days", type=int, default=0,
                    help="limit test days (0 = all test years)")
    sp.add_argument("--days-per-year", type=int, default=365)
    sp.add_argument("--n-boot", type=int, default=1000)
    sp.add_argument("--return-periods", type=int, nargs="+",
                    default=[2, 5, 10, 20, 50, 100])
    sp.set_defaults(fn=cmd_extremes)

    sp = sub.add_parser("pack", help="dataset split -> packed-array conversion")
    common(sp)
    sp.add_argument("--split", choices=("train", "val", "test"),
                    default="train")
    sp.add_argument("--out", required=True, help="output .npz path")
    sp.set_defaults(fn=cmd_pack)

    sp = sub.add_parser("sweep", help="hyperparameter grid sweep")
    common(sp)
    sp.add_argument("--spec", default=None,
                    help="JSON {dotted.key: [values...]} or a wandb-style sweeps.yaml "
                         "(reference sweeps.yaml:1-14 schema; needs PyYAML)")
    sp.add_argument("--grid", nargs="*", default=[], help="inline grid key=v1,v2,...")
    sp.add_argument("--metric", default="val_crps")
    sp.add_argument("--epochs", type=int, default=0,
                    help="override epochs per sweep point (0 = config value)")
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("bench", help="headline benchmark (BENCH_MODE, BENCH_* knobs)")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.device = cli_device()
    if _wants_ranks(args):
        from probunet_tpu_torch.parallel import multihost
        from probunet_tpu_torch.parallel.mesh import world

        multihost.initialize(args.device)
        args.device = multihost.rank_device(args.device)
        if world()[0] != 0:   # rank 0 speaks for the run
            with contextlib.redirect_stdout(io.StringIO()):
                return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
