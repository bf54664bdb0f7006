"""Typed configuration tree (the port's own copy of ``probunet_tpu/config.py``).

The same dataclasses, presets and (de)serialization as the JAX package's
configuration, kept here so the port imports nothing of ``probunet_tpu``;
``tests/test_torch_imports.py`` holds every preset's ``to_dict()`` equal to
the JAX package's. Some comments name JAX- or TPU-only knobs: the port
does not read ``rng_impl`` (TPU hardware RNG). It reads ``train.remat``
and ``train.remat_levels`` as the JAX CLI does
(``ProbabilisticUNet.from_config``: ``tuple(remat_levels) or remat``;
the modes are in ``models/unet.py``). Its GroupNorm-chain route
(``gn_impl``) is an argument of the model, not a configuration field,
as the JAX package's is an environment variable.

The comments on what each remat mode costs describe the TPU. On an H100
80GB HBM3 at 700 W (``chip_smoke.py``, flagship training step, bs=128)
the port measured: ``"save_convs"`` 0.79x the no-remat peak memory for
1.4-2.4x the step time (the selective checkpoint's per-operation
dispatch leaves the card idle); ``True`` 0.43x for 1.2-1.5x;
``remat_levels=(0,)`` 0.71x for 1.0-1.2x.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass
class DataConfig:
    """ClimEx data pipeline configuration.

    Mirrors the dataset kwargs of ``climex2torch``
    (reference src/climex_utils.py:61-70) plus TPU-side additions.
    """

    datadir: str = ""
    variables: tuple[str, ...] = ("pr", "tasmin", "tasmax")
    years_train: tuple[int, int] = (1960, 2020)   # [start, stop) like range()
    years_val: tuple[int, int] = (2021, 2033)
    years_test: tuple[int, int] = (2034, 2046)
    # [start_rlon, end_rlon, start_rlat, end_rlat] crop window
    # (reference src/train_prob_unet_model.py:34)
    coords: tuple[int, int, int, int] = (80, 208, 100, 228)
    resolution: tuple[int, int] = (128, 128)
    lowres_scale: int = 16
    # one of: lr_to_hr | lr_to_residuals | lrinterp_to_residuals | lrinterp_to_hr
    # (reference src/climex_utils.py:152-251)
    pipeline: str = "lrinterp_to_residuals"
    # upsampling mode for lrinterp. The reference's current stack uses torch
    # interpolate's DEFAULT (nearest!) at src/climex_utils.py:187,204,233;
    # the baseline stack uses explicit bilinear (src/baseline/climex_utils.py).
    interp_mode: str = "nearest"
    # apply softplus-inverse transforms: pr > 0, tasmax > tasmin
    # (reference src/climex_utils.py:136-138)
    transfo: bool = True
    # perpixel | none | pertimestep | minmax
    # (reference src/baseline/climex_utils.py:140-153)
    standardization: str = "perpixel"
    megafile: str | None = None
    # packed-array artifacts from `probunet_tpu pack` (one per split);
    # non-empty paths take precedence over datadir/synthetic sources
    packed_train: str = ""
    packed_val: str = ""
    packed_test: str = ""
    epsilon: float = 1e-10  # standardization epsilon (src/climex_utils.py:86)
    # synthetic-data mode for CI/bench when no NetCDF files are available
    synthetic: bool = False
    synthetic_seed: int = 0


@dataclass
class ModelConfig:
    """Probabilistic U-Net architecture.

    Defaults follow the flagship run in reference src/main.py:35-45.
    """

    input_channels: int = 3
    num_classes: int = 3
    latent_dim: int = 32
    num_filters: tuple[int, ...] = (32, 64, 128, 256)  # prior/posterior stacks
    model_channels: int = 32
    channel_mult: tuple[int, ...] = (1, 2, 4, 8)
    channel_mult_emb: int = 4
    num_blocks: int = 2
    dropout: float = 0.10
    label_dim: int = 1
    use_diffuse: bool = False
    # unet variant: symmetric | asymmetric_wskips | asymmetric_woskips
    # (reference src/networks.py:416-432)
    unet_type: str = "symmetric"
    # compute dtype for convs/matmuls ("float32" | "bfloat16"); params stay f32
    compute_dtype: str = "float32"


@dataclass
class LossConfig:
    """Reconstruction loss + ELBO weights.

    loss_type choices follow reference src/train_prob_unet_model.py:40 and the
    three ELBO variants in src/prob_unet.py:229-381.
    """

    loss_type: str = "afcrps"  # afcrps | crps | mse+ssim | l1
    alpha: float = 0.95        # afCRPS fairness parameter (prob_unet_utils.py:173)
    # WMSE+MS-SSIM parameters (reference src/prob_unet_utils.py:270-300)
    alpha_w: float = 0.007
    beta_w: float = 0.048
    lam_w: float = 0.0
    # ELBO weights (reference src/prob_unet.py:146-155, src/main.py:111-115)
    beta_0: float = 1.0
    beta_1: float = 0.0
    beta_2: float = 0.0
    max_beta_1: float = 1.0
    warmup_epochs: int = 2


@dataclass
class TrainConfig:
    """Optimization / loop settings (reference src/train_prob_unet_model.py:46-53)."""

    batch_size: int = 32
    num_epochs: int = 10
    patience: int = 15
    min_delta: float = 0.0
    lr: float = 1e-4
    weight_decay: float = 0.01  # AdamW default (torch.optim.AdamW)
    ensemble_size: int = 15     # M posterior draws in the ELBO (src/main.py:136)
    eval_ensemble_size: int = 5  # M for eval (src/main.py:162)
    # gradient accumulation: optimizer updates every `accum` micro-batches
    # (effective batch = accum * batch_size). The reference exposes
    # --accum (default 8, src/trainmodel.py:39, train_prob_unet_model.py:52)
    # but only its commented-out AMP path consumes it
    # (src/trainmodel.py:180-181) — the active path updates every batch,
    # so the behavior-matching default here is 1.
    accum: int = 1
    # global-norm gradient clip; 0 = off (the reference clips nothing).
    # Our extension for the throughput-optimal bs=128: the β₁ activation
    # after KL-unconstrained warm-up injects a one-step shock
    # (β₁·KL ~ 1e4) that NaN'd the bs=128 convergence run where bs=32
    # survived it (results/quality_bs128, r4 queue 3); clip=1.0 bounds
    # that single step without touching converged dynamics.
    grad_clip: float = 0.0
    seed: int = 42
    # PRNG implementation for the training rng stream: "rbg" uses the TPU
    # hardware RNG path (measured -39 ms/step vs threefry at the flagship
    # config — dropout masks dominate the threefry cost); "threefry2x32"
    # restores the JAX default
    rng_impl: str = "rbg"
    # memory/perf knobs.
    # remat: False | True | "save_convs". True checkpoints every U-Net
    # block with full recompute (admits larger batches; loses throughput —
    # DESIGN.md batch/remat ladder). "save_convs" checkpoints every block
    # under the save_only_these_names("conv_out") policy: convs are never
    # recomputed, only the elementwise GN/FiLM/SiLU/dropout chains between
    # them are replayed in the backward pass (dropout masks regenerated
    # from identical keys instead of stored) — a pure byte reduction on
    # the HBM-bound step. Numerics identical in all modes.
    remat: Any = False
    # checkpoint only the blocks at these resolution levels (e.g. (0,) or
    # (0, 1)): the shallow levels hold the largest activations, so this
    # buys most of full remat's memory at a fraction of its recompute.
    # Takes precedence over `remat` when non-empty.
    remat_levels: Tuple[int, ...] = ()
    log_every: int = 50
    checkpoint_every: int = 0    # steps; 0 = per-epoch only
    checkpoint_dir: str = "checkpoints"


@dataclass
class ParallelConfig:
    """Device-mesh layout. The reference has no parallelism (single GPU,
    reference src/prob_unet.py:10); this is the TPU-native scaling story."""

    data_axis: int = 0    # 0 = use all devices for data parallelism
    spatial_axis: int = 1  # spatial (H) sharding factor; 1 = off


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    # ---- serialization ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, val):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in val.items():
                if k not in fields:
                    raise KeyError(f"Unknown config key {tp.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            data=build(DataConfig, d.get("data", {})),
            model=build(ModelConfig, d.get("model", {})),
            loss=build(LossConfig, d.get("loss", {})),
            train=build(TrainConfig, d.get("train", {})),
            parallel=build(ParallelConfig, d.get("parallel", {})),
        )

    def override(self, dotted: dict[str, Any]) -> "Config":
        """Apply {"train.lr": 3e-4, ...}-style overrides, returning a new Config."""
        d = self.to_dict()
        for key, val in dotted.items():
            parts = key.split(".")
            cur = d
            for p in parts[:-1]:
                if not isinstance(cur, dict) or p not in cur:
                    raise KeyError(
                        f"Unknown config key: {key!r} (no section {p!r}; "
                        f"sections: {', '.join(d)})"
                    )
                cur = cur[p]
            if not isinstance(cur, dict) or parts[-1] not in cur:
                raise KeyError(
                    f"Unknown config key: {key!r} "
                    f"(valid keys in {'.'.join(parts[:-1]) or 'root'}: "
                    f"{', '.join(cur) if isinstance(cur, dict) else 'none'})"
                )
            cur[parts[-1]] = val
        return Config.from_dict(d)


# ---------------------------------------------------------------------------
# Named presets — one per BASELINE.json config.
# ---------------------------------------------------------------------------

def preset(name: str) -> Config:
    """Return a named preset Config.

    Names map to the five BASELINE.json configs:
      - deterministic_64        config 1: deterministic U-Net, 1 var, 64x64
      - probunet_latent6_64     config 2: prob U-Net latent 6, 64x64, 1 var
      - probunet_multivar_128   config 3: flagship 3-var 128x128, beta-annealed
      - ensemble16_infer        config 4: 16-member latent ensemble inference
      - fulldomain_dp8          config 5: full-domain tiled, DP over 8 chips
    """
    if name == "deterministic_64":
        c = Config()
        c.data.variables = ("pr",)
        c.data.resolution = (64, 64)
        c.data.coords = (120, 184, 120, 184)
        c.data.lowres_scale = 8
        c.model.input_channels = 1
        c.model.num_classes = 1
        c.model.unet_type = "symmetric"
        c.model.model_channels = 64
        c.model.channel_mult = (1, 2, 3, 4)
        c.train.batch_size = 8
        c.loss.loss_type = "l1"
        return c
    if name == "probunet_latent6_64":
        c = Config()
        c.data.variables = ("pr",)
        c.data.resolution = (64, 64)
        c.data.coords = (120, 184, 120, 184)
        c.data.lowres_scale = 8
        c.model.input_channels = 1
        c.model.num_classes = 1
        c.model.latent_dim = 6
        return c
    if name == "probunet_multivar_128":
        # flagship: reference src/main.py:35-45 exactly
        return Config()
    if name == "ensemble16_infer":
        c = Config()
        c.train.ensemble_size = 16
        c.train.eval_ensemble_size = 16
        return c
    if name == "fulldomain_dp8":
        # BASELINE config 5: full ClimEx domain (280x280, the native grid —
        # reference src/baseline/climex_utils.py EDA operates on it), tiled
        # into 128x128 windows for inference, 32-member ensembles,
        # data-parallel over all (8) chips. Drive with
        # `infer-domain --preset fulldomain_dp8` (tiled inference; training
        # itself stays on 128x128 windows — use `train --dp -1` for that).
        c = Config()
        c.data.coords = (0, 280, 0, 280)       # full domain crop window
        c.data.resolution = (128, 128)         # tile size fed to the model
        c.parallel.data_axis = 0               # 0 = all devices on "data"
        c.train.ensemble_size = 32
        c.train.eval_ensemble_size = 32
        return c
    raise ValueError(f"Unknown preset: {name!r}")


PRESETS = (
    "deterministic_64",
    "probunet_latent6_64",
    "probunet_multivar_128",
    "ensemble16_infer",
    "fulldomain_dp8",
)
