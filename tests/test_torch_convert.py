"""The Flax -> port weight converter: round trip, strictness and the
parameter counts of both packages' models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, jax_tiny_model, torch_tiny_model

from probunet_tpu_torch.convert import convert_params, flax_params


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_round_trip_is_exact():
    _, params = jax_tiny_model()
    back = flax_params(torch_tiny_model(params))
    got, want = dict(_leaves(back)), dict(_leaves(params))
    assert set(got) == set(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        assert np.array_equal(got[path], arr), path


def test_layouts_are_transposed_as_documented():
    _, params = jax_tiny_model()
    sd = convert_params(params, torch_tiny_model(params))
    conv = params["unet"]["enc_16x16_conv"]["weight"]                   # HWIO
    assert np.array_equal(sd["unet.enc_16x16_conv.weight"].numpy(), conv.transpose(3, 2, 0, 1))
    lin = params["unet"]["enc_8x8_down"]["affine"]["weight"]            # (in, out)
    assert np.array_equal(sd["unet.enc_8x8_down.affine.weight"].numpy(), lin.T)
    gn = params["unet"]["out_norm"]["gn"]["scale"]
    assert np.array_equal(sd["unet.out_norm.weight"].numpy(), gn)
    fc = params["fcomb"]["layer1_weight"]                                # (1, 1, cin, cout)
    assert np.array_equal(sd["fcomb.layer1_weight"].numpy(), fc[0, 0])
    mu = params["prior"]["conv_mu"]["weight"]
    assert np.array_equal(sd["prior.conv_mu.weight"].numpy(), mu.transpose(3, 2, 0, 1))


def test_mismatches_raise():
    _, params = jax_tiny_model()
    model = torch_tiny_model(params)
    missing = {k: v for k, v in params.items() if k != "fcomb"}
    with pytest.raises(ValueError, match="not filled"):
        convert_params(missing, model)
    extra = dict(params, extra={"bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no port parameter"):
        convert_params(extra, model)
    bad = {k: dict(v) for k, v in params.items()}
    bad["fcomb"]["layer2_bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape mismatches"):
        convert_params(bad, model)


def _jax_param_count(res, **model_kw):
    from probunet_tpu.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet(**model_kw, img_resolution=res)
    x = jnp.zeros((1, *res, model_kw.get("input_channels", 3)))
    y = jnp.zeros((1, *res, model_kw.get("num_classes", 3)))
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k, "latent": k, "dropout": k}, x, y, training=True), jax.random.key(0))
    return sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_parameter_counts_match(size):
    """Counts only at the flagship size (``probunet_multivar_128``): the
    JAX side is traced by ``jax.eval_shape``, nothing runs at 128x128."""
    from probunet_tpu_torch.config import preset
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    if size == "tiny":
        kw = {k: v for k, v in TINY.items() if k != "img_resolution"}
        res = TINY["img_resolution"]
        port = ProbabilisticUNet(generator=torch.Generator().manual_seed(0), **TINY)
    else:
        cfg = preset("probunet_multivar_128")
        m = cfg.model
        kw = dict(input_channels=m.input_channels, num_classes=m.num_classes,
                  latent_dim=m.latent_dim, num_filters=m.num_filters,
                  model_channels=m.model_channels, channel_mult=m.channel_mult,
                  num_blocks=m.num_blocks)
        res = cfg.data.resolution
        port = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0),
                                             device="cpu")
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == _jax_param_count(res, **kw)
