"""The deterministic baselines, port against JAX (CPU).

- ``UNetAll`` of each type (``symmetric``, ``asymmetric_wskips`` and
  ``asymmetric_woskips``, the post-U-Nets' core at the grid divided by
  ``ds_scale``): the forward in training mode, dropout on, and every
  parameter gradient of a weighted sum of the output, the GroupNorm chains
  on the kernel route (kernels C/C′'s plain versions against the JAX
  package under ``PROBUNET_GN_IMPL=pallas``), the seed words each block
  hands its dropout recorded from the JAX kernels
  (``torch_parity.jax_grads_recording``). f32, rtol 1e-4 / atol 1e-5 (the
  model tests' tolerance), the gradients' atol 1e-5 of each tensor's
  largest magnitude (a sum over the whole output makes them O(1)).
- ``LinearCNN`` (Flax ``nn.Conv`` kernels carried over by ``convert.py``),
  forward and gradients, rtol 1e-5 / atol 1e-6.
- ``bcsd`` against the JAX function, rtol 1e-6 (the same f32 operations).
- Three steps of ``make_deterministic_train_step`` against the JAX step
  (AdamW by optax), each step's seed words those of the JAX step's
  ``fold_in(rng, step)`` key: each step's loss and per-variable losses and
  the parameters after three steps, rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from torch_parity import assert_close, jax_grads_recording, noisy_params
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.convert import convert_params, flax_params, load_params

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RTOL, ATOL = 1e-4, 1e-5
B = 2
# type -> (grid, ds_scale, input grid, core levels, blocks): the post-U-Nets
# take the low-resolution field, their core 64 channels wide (two stages of
# 2x up blocks; the skips need two blocks a level)
VARIANTS = {"symmetric": ((16, 16), 4, (16, 16), (1, 2), 1),
            "asymmetric_wskips": ((16, 16), 4, (4, 4), (1,), 2),
            "asymmetric_woskips": ((16, 16), 4, (4, 4), (1,), 1)}
UNET_KW = dict(in_channels=1, out_channels=1, model_channels=8, dropout=0.1)


def _jax_unet_all(unet_type):
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from probunet_tpu.models.unet import UNetAll

    res, ds, inp, mult, blocks = VARIANTS[unet_type]
    model = UNetAll(type=unet_type, img_resolution=res, ds_scale=ds, channel_mult=mult,
                    num_res_blocks=blocks, **UNET_KW)
    x = jnp.zeros((1, *inp, 1))
    shapes = jax.eval_shape(lambda k: model.init({"params": k, "dropout": k}, x),
                            jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       unfreeze(shapes["params"])), seed=11)
    return model, params


def _torch_unet_all(unet_type, params):
    from probunet_tpu_torch.models.unet import UNetAll

    res, ds, _, mult, blocks = VARIANTS[unet_type]
    model = UNetAll(unet_type, res, ds_scale=ds, channel_mult=mult, num_res_blocks=blocks,
                    generator=torch.Generator().manual_seed(0), **UNET_KW)
    return load_params(model, params)


@pytest.mark.parametrize("unet_type", list(VARIANTS))
def test_unet_variants_match_jax(monkeypatch, unet_type):
    import jax
    import jax.numpy as jnp

    jmodel, params = _jax_unet_all(unet_type)
    tmodel = _torch_unet_all(unet_type, params)
    res, _, inp, _, _ = VARIANTS[unet_type]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, *inp, 1)).astype(np.float32)
    w = rng.standard_normal((B, *res, 1)).astype(np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                           rngs={"dropout": jax.random.key(5)})
        return jnp.sum(out * w), out

    want, want_out, want_grads, seeds = jax_grads_recording(monkeypatch, loss, params)
    assert seeds.shape == (len(tmodel.dropout_blocks), 2)   # every core block, no fallback
    out = tmodel(torch.from_numpy(x), train=True, seeds=torch.from_numpy(seeds))
    assert out.shape == (B, *res, 1)
    assert_close(out.detach(), want_out, RTOL, ATOL, "forward")
    (out * torch.from_numpy(w)).sum().backward()
    want = convert_params(want_grads, tmodel)
    for name, prm in tmodel.named_parameters():
        assert prm.grad is not None, name
        assert_close(prm.grad, want[name], RTOL, ATOL * float(want[name].abs().max()),
                     f"d{name}")
    # the tree round-trips: every Flax leaf has its port parameter
    back = flax_params(tmodel)
    assert jax.tree.structure(back) == jax.tree.structure(params)


def test_linear_cnn_matches_jax():
    import jax
    import jax.numpy as jnp

    from probunet_tpu.models.baselines import LinearCNN as JaxLinearCNN

    from probunet_tpu_torch.models.baselines import LinearCNN

    jmodel = JaxLinearCNN(in_channels=3)
    x = np.random.default_rng(13).standard_normal((B, 12, 10, 2)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jnp.asarray(x)), jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       shapes["params"]), seed=14)
    tmodel = load_params(LinearCNN(3, input_channels=2,
                                   generator=torch.Generator().manual_seed(0)), params)
    want, grads = jax.value_and_grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) ** 2))(params)
    out = tmodel(torch.from_numpy(x))
    assert out.shape == (B, 12, 10, 3)
    val = (out ** 2).sum()
    val.backward()
    assert_close(val.detach(), want, 1e-5, 1e-6, "value")
    g = convert_params(grads, tmodel)
    for name, prm in tmodel.named_parameters():
        assert_close(prm.grad, g[name], 1e-5, 1e-6, f"d{name}")


def test_bcsd_matches_jax():
    from probunet_tpu.models.baselines import bcsd as jax_bcsd

    from probunet_tpu_torch.models.baselines import bcsd

    rng = np.random.default_rng(15)
    days = 12
    train_hr = rng.gamma(2.0, 1.0, (3 * days + 5, 4, 5, 2)).astype(np.float32)
    train_li = rng.gamma(2.0, 1.0, train_hr.shape).astype(np.float32)
    test_li = rng.gamma(2.0, 1.0, (2 * days + 3, 4, 5, 2)).astype(np.float32)
    want = jax_bcsd(train_hr, train_li, test_li, days_per_year=days)
    got = bcsd(*(torch.from_numpy(a) for a in (train_hr, train_li, test_li)),
               days_per_year=days)
    assert got.shape == (2 * days, 4, 5, 2)
    assert_close(got, want, 1e-6, 0.0, "bcsd")


def _det_cfgs(name):
    """(JAX config, port config) of deterministic_64 cut to a 16x16 grid."""
    import argparse

    from probunet_tpu.cli import build_config

    from probunet_tpu_torch import cli as tcli

    sets = ["data.resolution=[16,16]", "data.lowres_scale=4", "model.model_channels=8",
            "model.channel_mult=[1,2]", "model.num_blocks=1", "train.batch_size=2",
            "train.lr=0.001"]
    ns = argparse.Namespace(preset="deterministic_64", config=None, set=sets)
    return build_config(ns), tcli.build_config(ns)


def _step_seed_words(monkeypatch, jmodel, params, rng, steps):
    """The (n_blocks, 2) seed words the JAX step's U-Net hands its dropout
    at each of ``steps`` steps (key fold_in(rng, step)): flax derives them
    from the key and the block's path alone, so one forward traced once
    gives them."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.ops.pallas import dropout as jdrop
    from probunet_tpu.ops.pallas import fused_gn as jgn

    seeds = []
    gn, drop = jgn.gn_film_silu_dropout, jdrop.dropout

    def gn_rec(*args):
        if args[8] > 0.0:
            seeds.append(args[5])
        return gn(*args)

    def drop_rec(y, seed2, p):
        seeds.append(seed2)
        return drop(y, seed2, p)

    monkeypatch.setattr(jgn, "gn_film_silu_dropout", gn_rec)
    monkeypatch.setattr(jdrop, "dropout", drop_rec)

    @jax.jit
    def words(p, key):
        seeds.clear()
        jmodel.apply({"params": p}, jnp.zeros((2, 16, 16, 1)), train=True,
                     rngs={"dropout": key})
        return jnp.stack(seeds)

    p = jax.tree.map(jnp.asarray, params)
    out = [np.array(words(p, jax.random.fold_in(rng, s))) for s in range(steps)]
    monkeypatch.setattr(jgn, "gn_film_silu_dropout", gn)
    monkeypatch.setattr(jdrop, "dropout", drop)
    return out


@pytest.mark.parametrize("name", ["unet", "linearcnn"])
def test_deterministic_step_matches_jax(monkeypatch, name):
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from probunet_tpu.cli import build_config  # noqa: F401  (the JAX config tree)
    from probunet_tpu.data import climex as jc
    from probunet_tpu.models.baselines import LinearCNN as JaxLinearCNN
    from probunet_tpu.models.unet import UNetAll as JaxUNetAll
    from probunet_tpu.train.loop import make_deterministic_train_step as jax_step
    from probunet_tpu.train.state import TrainState, make_optimizer

    from probunet_tpu_torch import cli as tcli
    from probunet_tpu_torch.data import climex as tclimex
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
    from probunet_tpu_torch.train.loop import make_deterministic_train_step
    from probunet_tpu_torch.train.state import create_train_state

    jcfg, cfg = _det_cfgs(name)
    for k, v in (("PROBUNET_GN_IMPL", "pallas"), ("PROBUNET_DROPOUT_IMPL", "pallas")):
        monkeypatch.setenv(k, v)
    m = jcfg.model
    if name == "unet":
        jmodel = JaxUNetAll(type=m.unet_type, img_resolution=jcfg.data.resolution,
                            in_channels=1, ds_scale=jcfg.data.lowres_scale,
                            num_res_blocks=m.num_blocks, channel_mult=m.channel_mult,
                            out_channels=1, model_channels=m.model_channels,
                            dropout=m.dropout)
    else:
        jmodel = JaxLinearCNN(in_channels=1)
    x0 = jnp.zeros((1, 16, 16, 1))
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k, "dropout": k}, x0),
                            jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       unfreeze(shapes["params"])), seed=16)
    rng = jax.random.key(21)
    jstate = TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
                               tx=make_optimizer(jcfg.train.lr, jcfg.train.weight_decay),
                               rng=rng)
    hr = synthetic_climex_fields(6, 16, 16, ("pr",), seed=4)
    jstats = jc.compute_stats(jnp.asarray(hr), 4)
    tstats = tclimex.compute_stats(torch.from_numpy(hr), 4)

    model = load_params(tcli.make_det_model(cfg, name, "cpu"), params)
    state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device="cpu")
    tstep = make_deterministic_train_step(model, cfg)
    jstep = jax_step(jmodel, jcfg, donate=False)
    words = _step_seed_words(monkeypatch, jmodel, params, rng, 3) if name == "unet" else None
    for s in range(3):
        batch = hr[2 * s: 2 * s + 2]
        seeds = None
        if words is not None:   # the seed words of the JAX step's fold_in(rng, step) key
            assert words[s].shape == (len(model.dropout_blocks), 2)
            seeds = torch.from_numpy(words[s])
        jstate, jmet = jstep(jstate, jnp.asarray(batch), jstats)
        state, met = tstep(state, torch.from_numpy(batch), tstats, seeds=seeds)
        assert_close(met["loss"], jmet["loss"], RTOL, ATOL, f"loss, step {s}")
        assert_close(met["loss_per_var"], jmet["loss_per_var"], RTOL, ATOL, f"per var {s}")
    assert state.step == 3
    want = convert_params(jax.device_get(jstate.params), model)
    for key, val in model.state_dict().items():
        assert_close(val, want[key], RTOL, ATOL, f"{key} after three steps")


def test_chain_dropout_on_a_shape_kernel_d_does_not_take():
    """A composed chain whose activation kernel D does not take (a 1x1 chain
    of 192 channels at batch 8: 1,536 elements) drops out through
    ``other_shape_dropout``: the inverted dropout of a hash mask of the seed
    words, the same for the same words, another for others."""
    from probunet_tpu_torch.models.layers import EDMGroupNorm, other_shape_dropout
    from probunet_tpu_torch.ops.kernels import dropout

    x = torch.randn((8, 192, 1, 1), generator=torch.Generator().manual_seed(1))
    x = x.contiguous(memory_format=torch.channels_last)
    assert not dropout.supported((8, 1, 1, 192))
    gn = EDMGroupNorm(192, gn_impl="composed")
    seed = torch.tensor([5, -7], dtype=torch.int32)
    y = gn(x, silu=True, drop_p=0.1, drop_seed=seed)
    ref = gn(x, silu=True)
    want = other_shape_dropout(ref.permute(0, 2, 3, 1), seed, 0.1).permute(0, 3, 1, 2)
    assert torch.equal(y, want)
    kept = y != 0
    assert 0.8 < float(kept.float().mean()) < 0.97
    assert torch.allclose(y[kept], ref[kept] / 0.9, rtol=1e-6)
    other = gn(x, silu=True, drop_p=0.1, drop_seed=seed + 1)
    assert not torch.equal(other != 0, kept)
