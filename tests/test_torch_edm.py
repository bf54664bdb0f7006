"""The EDM diffusion family, port against JAX, on tiny models (CPU): the
noise embeddings, the attention block, the diffusion U-Net's mapping
network, ``EDMPrecond``, the EDM loss and its gradients on both GroupNorm
routes, one EDM AdamW step, and the Heun sampler and ensembles.

The models are 16x16, ``model_channels=8``, ``channel_mult=(1, 2)``, one
block a level; every Flax leaf is seeded noise (``torch_parity``) carried
over by ``convert.load_params``. The JAX side runs under
``PROBUNET_GN_IMPL=pallas`` (kernel C in interpret mode) for the port's
kernel route and under its default for the composed route
(``torch_parity.GN_ENV``, read when a JAX function is traced, so each test
traces its own). The random draws of the JAX functions (sigma, the unit
noise, the sampler's initial noise, the label-dropout keep draw, the
dropout seed words) are computed or recorded on the JAX side and handed
to the port.

Tolerances, as max |port - JAX| against rtol x max |JAX| per tensor
(``_close``): f32 forward 1e-5 (the same f32 arithmetic in other orders
through a few convolutions); the loss 1e-5 and each parameter's gradient
1e-4 (forward and back through ~12 layers); the parameters after one
AdamW step 1e-5 where the gradient stands clear of its tolerance, else
within 2 lr (see the test); the sampler and the
ensemble 1e-4 (7 and 5 denoiser calls compounding f32 differences at
sigma up to 80); bf16 2e-2 (a few bf16 roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import unfreeze

from torch_parity import GN_ENV, jax_grads_recording, noisy_params
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.convert import convert_params, load_params

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RES, B, MC, MULT = 16, 2, 8, (1, 2)
F32, GRAD, SAMPLER, BF16 = 1e-5, 1e-4, 1e-4, 2e-2


def _close(got, want, rtol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _noisy_tree(module, seed, *args, **kwargs):
    """Seeded-noise Flax params of ``module`` (shapes by ``eval_shape``;
    ``nn.Module.init`` since ``UNetBlock`` has a field named ``init``)."""
    shapes = jax.eval_shape(lambda k: nn.Module.init(module, k, *args, **kwargs),
                            jax.random.key(seed))
    return noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                     unfreeze(shapes["params"])), seed)


def _gn_route(monkeypatch, gn_impl):
    for k, v in GN_ENV[gn_impl].items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# Embeddings and the attention block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("endpoint", [False, True])
def test_positional_embedding(endpoint):
    from probunet_tpu.models.layers import PositionalEmbedding as JPos

    from probunet_tpu_torch.models.layers import PositionalEmbedding

    x = np.log(np.array([0.002, 0.3, 1.0, 17.0, 80.0], np.float32)) / 4
    want = JPos(num_channels=16, endpoint=endpoint).apply({}, jnp.asarray(x))
    got = PositionalEmbedding(16, endpoint=endpoint)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want, F32, "positional embedding")


def test_fourier_embedding():
    from probunet_tpu.models.layers import FourierEmbedding as JFourier

    from probunet_tpu_torch.models.layers import FourierEmbedding

    jmod = JFourier(num_channels=16)
    x = np.linspace(-2, 1.1, 5).astype(np.float32)
    params = jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = jmod.apply({"params": params}, jnp.asarray(x))
    port = load_params(FourierEmbedding(16, generator=torch.Generator().manual_seed(0)),
                       params)
    _close(port(torch.from_numpy(x)), want, F32, "fourier embedding")


@pytest.mark.parametrize("dtype_name,gn_impl,adaptive", [
    ("float32", "kernel", True), ("bfloat16", "kernel", True),
    ("float32", "composed", False)])
def test_attention_block(monkeypatch, dtype_name, gn_impl, adaptive):
    """``UNetBlock(attention=True)`` (two heads, skip scale sqrt(1/2)),
    with ``adaptive_scale=False`` on the composed route."""
    from probunet_tpu.models.layers import UNetBlock as JBlock

    from probunet_tpu_torch.models.layers import UNetBlock

    _gn_route(monkeypatch, gn_impl)
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else None
    tdt = torch.bfloat16 if dtype_name == "bfloat16" else None
    cin, cout, emb_c = 8, 16, 32
    kw = dict(attention=True, num_heads=2, skip_scale=0.5 ** 0.5, adaptive_scale=adaptive)
    jblock = JBlock(out_channels=cout, dtype=jdt, **kw)
    x, emb = _randn(1, B, 8, 8, cin), _randn(2, B, emb_c)
    if jdt is not None:
        x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
    params = _noisy_tree(jblock, 5, jnp.asarray(x), jnp.asarray(emb))
    cast = (lambda a: jnp.asarray(a, jdt)) if jdt is not None else jnp.asarray
    want = jax.jit(lambda p: nn.Module.apply(jblock, {"params": p}, cast(x), cast(emb)))(params)
    block = load_params(UNetBlock(cin, cout, emb_c, generator=torch.Generator().manual_seed(0),
                                  dtype=tdt, gn_impl=gn_impl, **kw), params)
    tx, temb = torch.from_numpy(x), torch.from_numpy(emb)
    if tdt is not None:
        tx, temb = tx.to(tdt), temb.to(tdt)
    got = block(tx.permute(0, 3, 1, 2), temb).permute(0, 2, 3, 1)
    assert got.dtype == (tdt or torch.float32)
    _close(got.float(), np.asarray(want, np.float32), BF16 if tdt else F32, "attention block")


# ---------------------------------------------------------------------------
# The diffusion U-Net's mapping network
# ---------------------------------------------------------------------------

def _unets(label_dim, use_diffuse, label_dropout=0.0, seed=3, gn_impl="composed"):
    from probunet_tpu.models.unet import UNet as JUNet

    from probunet_tpu_torch.models.unet import UNet

    kw = dict(label_dim=label_dim, model_channels=MC, channel_mult=MULT, num_blocks=1,
              dropout=0.0, label_dropout=label_dropout, use_diffuse=use_diffuse)
    jnet = JUNet(img_resolution=(RES, RES), in_channels=3, out_channels=3, **kw)
    x = jnp.zeros((B, RES, RES, 3))
    labels = jnp.zeros((B, label_dim)) if label_dim else None
    params = _noisy_tree(jnet, seed, x, noise_labels=jnp.zeros((B,)), class_labels=labels)
    tnet = load_params(UNet((RES, RES), 3, 3, generator=torch.Generator().manual_seed(0),
                            gn_impl=gn_impl, **kw), params)
    return jnet, params, tnet


@pytest.mark.parametrize("case", ["noise_labels", "class_labels"])
def test_diffusion_unet_embedding(monkeypatch, case):
    """``UNet(use_diffuse=True)`` with noise labels and no label map, and
    with class labels through ``map_label`` besides (composed route)."""
    _gn_route(monkeypatch, "composed")
    label_dim = 3 if case == "class_labels" else 0
    jnet, params, tnet = _unets(label_dim, True)
    x, nl = _randn(7, B, RES, RES, 3), np.array([-1.3, 0.9], np.float32)
    labels = _randn(8, B, 3) if label_dim else None
    want = jax.jit(lambda p: jnet.apply(
        {"params": p}, jnp.asarray(x), noise_labels=jnp.asarray(nl),
        class_labels=None if labels is None else jnp.asarray(labels)))(params)
    got = tnet(torch.from_numpy(x), noise_labels=torch.from_numpy(nl),
               class_labels=None if labels is None else torch.from_numpy(labels))
    _close(got, want, F32, case)
    # the noise labels reach the output: other labels, another result
    other = tnet(torch.from_numpy(x), noise_labels=torch.from_numpy(nl + 1),
                 class_labels=None if labels is None else torch.from_numpy(labels))
    assert float((other - got).abs().max()) > 1e-3


def test_label_dropout_with_the_jax_keep_draw(monkeypatch):
    """Label dropout in training: the port takes the (B, 1) keep mask the
    JAX U-Net draws (recorded from its ``jax.random.uniform``; composed
    route)."""
    _gn_route(monkeypatch, "composed")
    b = 4
    jnet, params, tnet = _unets(3, False, label_dropout=0.5)
    x, labels = _randn(9, b, RES, RES, 3), _randn(10, b, 3)
    draws, uniform = [], jax.random.uniform

    def recording(key, shape=(), dtype=float, *args, **kwargs):
        u = uniform(key, shape, dtype, *args, **kwargs)
        draws.append(u)
        return u

    monkeypatch.setattr(jax.random, "uniform", recording)

    def run(p):
        draws.clear()
        out = jnet.apply({"params": p}, jnp.asarray(x), class_labels=jnp.asarray(labels),
                         train=True, rngs={"dropout": jax.random.key(4)})
        return out, draws[0]

    want, u = jax.jit(run)(params)
    keep = np.asarray(u) >= 0.5
    assert keep.shape == (b, 1) and 0 < keep.sum() < b    # some labels dropped, some kept
    got = tnet(torch.from_numpy(x), train=True, class_labels=torch.from_numpy(labels),
               label_keep=torch.from_numpy(keep))
    _close(got, want, F32, "label dropout")
    kept_all = tnet(torch.from_numpy(x), class_labels=torch.from_numpy(labels))
    assert float((kept_all - got).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# EDMPrecond, the loss, the train step
# ---------------------------------------------------------------------------

def _edm_pair(cond: bool = True, dropout: float = 0.0, gn_impl: str = "kernel", seed: int = 11):
    """(JAX EDMPrecond, its noisy params, the port's with those weights)."""
    from probunet_tpu.models.edm import EDMPrecond as JEDM

    from probunet_tpu_torch.models.edm import EDMPrecond

    cin = 6 if cond else 3
    kw = dict(model_channels=MC, channel_mult=MULT, num_blocks=1, dropout=dropout)
    jm = JEDM(img_resolution=(RES, RES), in_channels=cin, out_channels=3, **kw)
    x = jnp.zeros((B, RES, RES, 3))
    params = _noisy_tree(jm, seed, x, jnp.ones((B,)),
                         condition_img=jnp.zeros((B, RES, RES, 3)) if cond else None)
    tm = EDMPrecond((RES, RES), cin, 3, generator=torch.Generator().manual_seed(0),
                    gn_impl=gn_impl, **kw)
    return jm, params, load_params(tm, params)


@pytest.mark.parametrize("cond,gn_impl", [(True, "kernel"), (False, "composed")],
                         ids=["condition-kernel", "no_condition-composed"])
def test_edm_precond(monkeypatch, cond, gn_impl):
    _gn_route(monkeypatch, gn_impl)
    jm, params, tm = _edm_pair(cond, gn_impl=gn_impl)
    x, c = _randn(12, B, RES, RES, 3), _randn(13, B, RES, RES, 3)
    sigma = np.array([0.03, 17.0], np.float32)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(sigma),
                                      condition_img=jnp.asarray(c) if cond else None))(params)
    got = tm(torch.from_numpy(x), torch.from_numpy(sigma),
             condition_img=torch.from_numpy(c) if cond else None)
    _close(got, want, F32, "EDMPrecond")


def _jax_seed_words(monkeypatch, fn, params):
    """The (n_blocks, 2) seed words the JAX U-Net's blocks hand their
    dropout (kernel C or D) in ``fn(params)``, traced forward only on the
    composed route (they depend on the key and the block's path alone)."""
    from probunet_tpu.ops.pallas import dropout as jdrop

    _gn_route(monkeypatch, "composed")
    words, kernel = [], jdrop.dropout

    def recording(y, seed2, p_drop):
        words.append(seed2)
        return kernel(y, seed2, p_drop)

    monkeypatch.setattr(jdrop, "dropout", recording)

    def run(p):
        words.clear()
        fn(p)
        return jnp.stack(words)

    out = np.array(jax.jit(run)(jax.tree.map(jnp.asarray, params)))
    monkeypatch.setattr(jdrop, "dropout", kernel)
    return out


def _loss_draws(rng, target_shape, p_mean=-1.2, p_std=1.2):
    """(sigma, unit noise) that the JAX ``edm_loss`` draws from ``rng``."""
    sig_rng, eps_rng, _ = jax.random.split(rng, 3)
    sigma = jnp.exp(p_mean + p_std * jax.random.normal(sig_rng, (target_shape[0],)))
    return np.asarray(sigma), np.asarray(jax.random.normal(eps_rng, target_shape))


@pytest.mark.parametrize("gn_impl", ["kernel", "composed"])
def test_edm_loss_and_gradients(monkeypatch, gn_impl):
    """The training loss (dropout 0.1) and every parameter's gradient, with
    JAX's sigma, noise and the seed words its blocks hand their dropout."""
    from probunet_tpu.train.edm import edm_loss as jax_edm_loss

    from probunet_tpu_torch.train.edm import edm_loss

    jm, params, tm = _edm_pair(dropout=0.1, gn_impl=gn_impl)
    y, c = _randn(14, B, RES, RES, 3), _randn(15, B, RES, RES, 3)
    rng = jax.random.key(21)
    value, _, grads, seeds = jax_grads_recording(
        monkeypatch, lambda p: (jax_edm_loss(jm, p, rng, jnp.asarray(y), jnp.asarray(c)), 0.0),
        params, gn_impl)
    assert seeds.shape == (len(tm.dropout_blocks), 2)
    sigma, noise = _loss_draws(rng, y.shape)
    loss = edm_loss(tm, torch.from_numpy(y), torch.from_numpy(c), sigma=torch.from_numpy(sigma),
                    noise=torch.from_numpy(noise), seeds=torch.from_numpy(seeds))
    loss.backward()
    _close(loss, value, F32, "loss")
    want = convert_params(grads, tm)
    for name, prm in tm.named_parameters():
        _close(prm.grad, want[name], GRAD, f"d{name}")
    # the per-sample FiLM reaches the mapping network
    assert float(tm.model.map_layer0.weight.grad.abs().max()) > 0


def test_edm_train_step_matches_jax(monkeypatch):
    """One ``make_edm_train_step`` AdamW step (lr 1e-3, wd 0.01) against
    the JAX step on the same raw HR batch, draws and seed words (composed
    route: the kernel route's gradients are held above)."""
    from probunet_tpu.config import Config as JConfig
    from probunet_tpu.data.climex import compute_stats as jstats
    from probunet_tpu.data.climex import preprocess_batch as jpre
    from probunet_tpu.train.edm import edm_loss as jax_edm_loss
    from probunet_tpu.train.edm import make_edm_train_step as jax_step
    from probunet_tpu.train.state import TrainState as JState
    from probunet_tpu.train.state import make_optimizer as jopt

    from probunet_tpu_torch.config import Config
    from probunet_tpu_torch.data.climex import compute_stats, preprocess_batch
    from probunet_tpu_torch.train.edm import edm_loss, make_edm_train_step
    from probunet_tpu_torch.train.state import create_train_state

    _gn_route(monkeypatch, "composed")
    jm, params, tm = _edm_pair(dropout=0.1, gn_impl="composed")
    hr_all = np.abs(_randn(16, 8, RES, RES, 3)) + 0.1
    hr = hr_all[:B]
    jcfg, cfg = JConfig(), Config()
    for c in (jcfg, cfg):
        c.data.resolution, c.data.lowres_scale = (RES, RES), 4
    jst = jstats(jnp.asarray(hr_all), 4)
    state = JState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, params),
                          tx=jopt(1e-3), rng=jax.random.key(5))
    rng = jax.random.fold_in(state.rng, state.step)
    batch = jpre(jnp.asarray(hr), jst, jcfg.data.pipeline, 4)
    seeds = _jax_seed_words(
        monkeypatch, lambda p: jax_edm_loss(jm, p, rng, batch["targets"], batch["inputs"]),
        params)
    assert seeds.shape == (len(tm.dropout_blocks), 2)
    sigma, noise = _loss_draws(rng, batch["targets"].shape)
    new_state, jmet = jax_step(jm, jcfg, donate=False)(state, jnp.asarray(hr), jst)

    tstats = compute_stats(torch.from_numpy(hr_all), 4)
    tbatch = preprocess_batch(torch.from_numpy(hr), tstats, cfg.data.pipeline, 4)
    draws = dict(sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise),
                 seeds=torch.from_numpy(seeds))
    # the port's gradients, held to JAX's by test_edm_loss_and_gradients
    grads = dict(zip([n for n, _ in tm.named_parameters()], torch.autograd.grad(
        edm_loss(tm, tbatch["targets"], tbatch["inputs"], **draws), list(tm.parameters()))))
    tstate = create_train_state(tm, lr=1e-3, device="cpu")
    _, met = make_edm_train_step(tm, cfg)(tstate, torch.from_numpy(hr), tstats, **draws)
    _close(met["loss"], jmet["loss"], F32, "loss")
    _close(met["grad_norm"], jmet["grad_norm"], GRAD, "grad_norm")
    # AdamW's first update is lr * g / (|g| + 1e-8): sign(g) * lr wherever
    # the gradient stands clear of its tolerance, so the parameters agree
    # there to F32; where |g| is within 10 x GRAD of the leaf's largest,
    # a gradient known to GRAD leaves the update undetermined in [-lr, lr]
    # (plus the same decay), so those move by at most 2 lr apart
    want = convert_params(jax.device_get(new_state.params), tm)
    for name, prm in tm.named_parameters():
        g = grads[name].abs()
        clear = (g > 10 * GRAD * g.max()).numpy()
        assert clear.any(), name
        _close(prm.detach()[clear], want[name][clear], F32, name)
        assert float((prm.detach() - want[name]).abs().max()) <= 2 * 1e-3 * (1 + 1e-3), name
    assert tstate.step == 1


# ---------------------------------------------------------------------------
# The Heun sampler and ensembles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sampler_pair():
    """The sampler's models on the composed route (the kernel route's
    denoiser is held by ``test_edm_precond``)."""
    return _edm_pair(seed=17, gn_impl="composed")


def test_edm_sample_matches_jax(monkeypatch, sampler_pair):
    """4 steps (7 denoiser calls, the last step Euler alone) from JAX's
    initial noise."""
    from probunet_tpu.train.edm import edm_sample as jax_sample

    from probunet_tpu_torch.train.edm import edm_sample, edm_sigmas

    _gn_route(monkeypatch, "composed")
    jm, params, tm = sampler_pair
    c, shape, rng = _randn(18, B, RES, RES, 3), (B, RES, RES, 3), jax.random.key(6)
    want = jax.jit(lambda p: jax_sample(jm, p, rng, shape, jnp.asarray(c), num_steps=4))(params)
    calls = []
    hook = tm.register_forward_hook(lambda *_: calls.append(1))
    got = edm_sample(tm, shape, torch.from_numpy(c), num_steps=4,
                     noise=torch.from_numpy(np.asarray(jax.random.normal(rng, shape))))
    hook.remove()
    assert len(calls) == 7
    _close(got, want, SAMPLER, "edm_sample")
    # the schedule is the JAX sampler's f32 formula, evaluated by XLA
    i = jnp.arange(4)
    rho, smax, smin = 7.0, 80.0, 0.002
    want_sigmas = (smax ** (1 / rho) + i / 3 * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
    np.testing.assert_allclose(edm_sigmas(4)[:-1], np.asarray(want_sigmas), rtol=1e-6)
    assert edm_sigmas(4)[-1] == 0


def test_edm_ensemble_matches_jax(monkeypatch, sampler_pair):
    """M=3 members at 3 steps, the members' initial noise from JAX's
    split keys, batched as M * B against JAX's vmap."""
    from probunet_tpu.train.edm import edm_ensemble as jax_ensemble

    from probunet_tpu_torch.train.edm import edm_ensemble

    _gn_route(monkeypatch, "composed")
    jm, params, tm = sampler_pair
    c, shape, rng, m = _randn(19, B, RES, RES, 3), (B, RES, RES, 3), jax.random.key(7), 3
    want = jax.jit(lambda p: jax_ensemble(jm, p, rng, shape, jnp.asarray(c), m,
                                          num_steps=3))(params)
    noise = np.stack([np.asarray(jax.random.normal(k, shape))
                      for k in jax.random.split(rng, m)])
    got = edm_ensemble(tm, shape, torch.from_numpy(c), m, noise=torch.from_numpy(noise),
                       num_steps=3)
    assert got.shape == (B, m, RES, RES, 3)
    _close(got, want, SAMPLER, "edm_ensemble")
    assert float((got[:, 0] - got[:, 1]).abs().max()) > 1e-3
