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
def jax_tiny_model(dtype_name: str = "float32", seed: int = 0, dropout: float = 0.0,
                   num_filters: tuple[int, ...] = TINY["num_filters"]):
    """(flax module, noisy numpy params) of the tiny Probabilistic U-Net
    (``dropout``: the U-Net blocks' rate in training mode; ``num_filters``:
    the encoders' widths, the first also the U-Net's output and Fcomb's
    width)."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from probunet_tpu.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet(
        **{**TINY, "num_filters": num_filters}, dropout=dropout,
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


def torch_tiny_model(params, dtype_name: str = "float32", dropout: float = 0.0,
                     gn_impl: str = "kernel", remat=False,
                     num_filters: tuple[int, ...] = TINY["num_filters"]):
    """The port's tiny Probabilistic U-Net loaded with ``params``, its
    GroupNorm chains on route ``gn_impl``. Every activation the composed
    route's dropout sees is one kernel D takes (numel a multiple of 1024 at
    batch 2 and above). Kernel C takes every chain shape but one: norm1 of
    ``enc_8x8_down`` (8x8, C=8) runs the composed chain on either route,
    as in the JAX package."""
    import torch

    from probunet_tpu_torch.convert import load_params
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet(
        generator=torch.Generator().manual_seed(0), **{**TINY, "num_filters": num_filters},
        dropout=dropout,
        dtype=torch.bfloat16 if dtype_name == "bfloat16" else None, gn_impl=gn_impl,
        remat=remat)
    return load_params(model, params).eval()


# the JAX package's environment for each of the port's GroupNorm routes
# (read when a JAX function is traced, so each route needs its own trace)
GN_ENV = {"kernel": {"PROBUNET_GN_IMPL": "pallas", "PROBUNET_DROPOUT_IMPL": "pallas"},
          "composed": {"PROBUNET_GN_IMPL": "xla", "PROBUNET_DROPOUT_IMPL": "pallas"}}


def jax_elbo_grads(monkeypatch, jmodel, params, x, y, eps, loss_type, fused, beta_1, m,
                   gn_impl="composed", record=True):
    """(loss, metrics, grads, seed words) of the JAX training ELBO on the
    GroupNorm route ``gn_impl``, with the posterior noise ``eps`` and the
    seed words each U-Net block hands its dropout recorded, in block order
    (kernel C's or, on the composed route and for a shape kernel C does not
    take, kernel D's). Traced and compiled
    as one program: an eager run compiles each of the U-Net's operations
    on its own, which takes several times longer. ``record=False`` records
    nothing and returns None for the seed words: inside ``nn.remat`` a
    recorded value would leak a tracer (``jax_dropout_seeds`` gives the
    same words)."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.ops.pallas import dropout as jdrop
    from probunet_tpu.ops.pallas import fused_gn as jgn

    seeds = []

    def recording(kernel, p_at, seed_at):
        def run(*args):
            if args[p_at] > 0.0:
                seeds.append(args[seed_at])
            return kernel(*args)
        return run

    for k, v in GN_ENV[gn_impl].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PROBUNET_FUSED_ELBO", "1" if fused else "0")
    if record:
        monkeypatch.setattr(jgn, "gn_film_silu_dropout",
                            recording(jgn.gn_film_silu_dropout, 8, 5))
        monkeypatch.setattr(jdrop, "dropout", recording(jdrop.dropout, 2, 1))
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * eps)

    def loss(p):
        seeds.clear()
        total, metrics = jmodel.apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(y), M=m, loss_type=loss_type,
            beta_1=beta_1, training=True, method=type(jmodel).elbo,
            rngs={"latent": jax.random.key(1), "dropout": jax.random.key(2)})
        return total, (metrics, jnp.stack(seeds) if record else None)

    (total, (metrics, seed_words)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return (total, metrics, jax.device_get(grads),
            np.array(seed_words) if record else None)


def jax_dropout_seeds(monkeypatch, jmodel, params, x):
    """The (n_blocks, 2) seed words the U-Net's blocks hand their dropout in
    ``jax_elbo_grads``'s ELBO: flax derives each block's key from the
    ``dropout`` rng and the block's path, so a U-Net forward alone, on
    the composed route and without remat, gives the same words."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.models.prob_unet import ProbabilisticUNet
    from probunet_tpu.ops.pallas import dropout as jdrop

    plain = ProbabilisticUNet(**{f: getattr(jmodel, f) for f in TINY}, dropout=jmodel.dropout)
    seeds = []
    kernel = jdrop.dropout

    def recording(y, seed2, p_drop):
        seeds.append(seed2)
        return kernel(y, seed2, p_drop)

    for k, v in GN_ENV["composed"].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jdrop, "dropout", recording)

    def forward(p, a):
        seeds.clear()
        plain.apply({"params": p}, a, method=lambda m, a: m.unet(a, train=True),
                    rngs={"dropout": jax.random.key(2)})
        return jnp.stack(seeds)

    words = np.array(jax.jit(forward)(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    monkeypatch.setattr(jdrop, "dropout", kernel)
    return words


def assert_close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)
