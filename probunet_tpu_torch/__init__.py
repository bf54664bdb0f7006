"""probunet_tpu_torch — the PyTorch/CUDA port of ``probunet_tpu``.

The JAX package ``probunet_tpu`` is the frozen reference; this package
mirrors its module paths (``models/unet.py`` <-> ``models/unet.py``) and
its public layouts: NHWC fields ``(B, H, W, C)``, ensembles
``(B, M, H, W, K)``, latents ``(M, B, D)``. It imports torch, numpy and
the standard library only — never jax, flax or anything of
``probunet_tpu``; ``config.py`` is its own copy of the configuration tree.

Ported so far: the serve path — device-side preprocessing, the
Probabilistic U-Net forward (U-Net, prior/posterior Gaussians, Fcomb),
the no-grad afCRPS/CRPS eval ELBO, prior-ensemble sampling and the
streamed ensemble metrics — and the training path: the afCRPS/CRPS
training ELBO with dropout, its backward, AdamW as optax computes it,
checkpoints and the epoch loop — and the serve command line: host ingest
(``data.climex.ClimexDataset``, the packed artifact), the streamed
evaluation and GEV extremes behind ``python -m probunet_tpu_torch
pack|evaluate|extremes`` (``cli.py``) — and the training command line:
``train`` (``Trainer`` over packed splits, the batches prefetched from
pinned memory) and ``train-det`` (the asymmetric U-Nets, ``LinearCNN``,
BCSD), with all four ELBOs (afCRPS, CRPS, WMSE + MS-SSIM, L1). The TPU's
Pallas kernels on those
paths are hand-written CUDA C++ for Hopper in ``csrc/`` (see
``ops/kernels``). The entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (the CLI: ``PROBUNET_PLATFORM=cpu``).
"""

__version__ = "0.1.0"
