"""Shared fixtures of the parity tests between ``probunet_tpu`` (JAX, the
reference) and ``probunet_tpu_torch`` (the port): one tiny Probabilistic
U-Net built in both packages with the same weights.

A fresh init is a poor parity input: ``UNetBlock.conv1`` and
``UNet.out_conv`` start at zero, so the U-Net's features would be exactly
0. Every leaf of the Flax tree is therefore overwritten with seeded numpy
noise (weights ~ N(0, 1/fan_in), biases and GN shifts ~ N(0, 0.1^2), GN
scales ~ 1 + N(0, 0.1^2)) before ``convert.load_params`` carries it over.
"""

from __future__ import annotations

import functools

import numpy as np

TINY = dict(input_channels=3, num_classes=3, latent_dim=4, num_filters=(8, 16),
            model_channels=8, channel_mult=(1, 2), img_resolution=(16, 16),
            num_blocks=1)


def _noisy_leaf(path: tuple[str, ...], arr: np.ndarray, rng) -> np.ndarray:
    noise = rng.standard_normal(arr.shape)
    name = path[-1]
    if path[-2:] == ("gn", "scale"):
        out = 1.0 + 0.1 * noise
    elif name == "weight" or name.endswith("_weight"):
        fan_in = int(np.prod(arr.shape[:-1]))
        out = noise / np.sqrt(fan_in)
    else:
        out = 0.1 * noise
    return out.astype(np.float32)


def noisy_params(params, seed: int):
    """Every leaf of a nested Flax param dict replaced by seeded noise."""
    rng = np.random.default_rng(seed)

    def walk(tree, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else _noisy_leaf(prefix + (k,), np.asarray(v), rng)
                for k, v in sorted(tree.items())}

    return walk(params, ())


@functools.lru_cache(maxsize=4)
def jax_tiny_model(dtype_name: str = "float32", seed: int = 0, dropout: float = 0.0):
    """(flax module, noisy numpy params) of the tiny Probabilistic U-Net
    (``dropout``: the U-Net blocks' rate in training mode)."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from probunet_tpu.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet(
        **TINY, dropout=dropout,
        dtype=jnp.bfloat16 if dtype_name == "bfloat16" else None)
    h, w = TINY["img_resolution"]
    x = jnp.zeros((1, h, w, TINY["input_channels"]))
    y = jnp.zeros((1, h, w, TINY["num_classes"]))
    # the tree's structure and shapes only (tracing, no compile): every
    # leaf is replaced by noise anyway
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "latent": k, "dropout": k}, x, y, training=True),
        jax.random.key(seed))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), unfreeze(shapes["params"]))
    return model, noisy_params(params, seed)


def torch_tiny_model(params, dtype_name: str = "float32", dropout: float = 0.0):
    """The port's tiny Probabilistic U-Net loaded with ``params``. Every
    activation its dropout sees is a shape the dropout kernel takes (numel
    a multiple of 1024 at batch 2 and above)."""
    import torch

    from probunet_tpu_torch.convert import load_params
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet(
        generator=torch.Generator().manual_seed(0), **TINY, dropout=dropout,
        dtype=torch.bfloat16 if dtype_name == "bfloat16" else None)
    return load_params(model, params).eval()


def assert_close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)
