"""Port models against the JAX package's, on the same weights and inputs.

f32 on the CPU, rtol 1e-4 / atol 1e-5: the two frameworks sum convolutions
and GroupNorm statistics in other orders (flax's GroupNorm takes the fast
variance E[x^2] - E[x]^2, which the port reproduces, but XLA and ATen
reduce in different orders), and the errors grow through ~20 conv layers.
The port's GroupNorm chains run the composed route here, the JAX default's
counterpart; the kernel route is held to the JAX package under
``PROBUNET_GN_IMPL=pallas`` in test_torch_serve.py, test_torch_train.py
and test_torch_fused_gn.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close, jax_tiny_model, torch_tiny_model

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def models():
    jmodel, params = jax_tiny_model()
    return jmodel, params, torch_tiny_model(params, gn_impl="composed")


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    h, w = TINY["img_resolution"]
    x = rng.standard_normal((b, h, w, TINY["input_channels"])).astype(np.float32)
    y = rng.standard_normal((b, h, w, TINY["num_classes"])).astype(np.float32)
    return x, y


def _apply(jmodel, params, *args, method):
    return jmodel.apply({"params": params}, *args, method=method)


def test_unet_features_match(models):
    jmodel, params, tmodel = models
    x, _ = _inputs(0)
    want = _apply(jmodel, params, jnp.asarray(x),
                  method=lambda m, a: m.unet(a, train=False))
    with torch.no_grad():
        got = tmodel.unet(torch.from_numpy(x))
    assert float(np.abs(np.asarray(want)).mean()) > 1e-2  # features are not trivially 0
    assert_close(got, want, RTOL, ATOL, "unet")


@pytest.mark.parametrize("which", ["prior", "posterior"])
def test_gaussian_matches(models, which):
    jmodel, params, tmodel = models
    x, y = _inputs(1)
    args = (jnp.asarray(x),) if which == "prior" else (jnp.asarray(x), jnp.asarray(y))
    want = _apply(jmodel, params, *args, method=lambda m, *a: getattr(m, which)(*a))
    with torch.no_grad():
        targs = [torch.from_numpy(a) for a in ((x,) if which == "prior" else (x, y))]
        got = getattr(tmodel, which)(*targs)
    assert_close(got.mu, want.mu, RTOL, ATOL, f"{which} mu")
    assert_close(got.log_sigma, want.log_sigma, RTOL, ATOL, f"{which} log_sigma")


@pytest.mark.parametrize("members", [0, 3])
def test_fcomb_matches(models, members):
    """``Fcomb.__call__`` (members=0: one z per item) and ``ensemble``."""
    jmodel, params, tmodel = models
    rng = np.random.default_rng(2)
    h, w = TINY["img_resolution"]
    feats = rng.standard_normal((2, h, w, TINY["num_filters"][0])).astype(np.float32)
    zshape = (2, TINY["latent_dim"]) if not members else (members, 2, TINY["latent_dim"])
    zs = rng.standard_normal(zshape).astype(np.float32)
    want = _apply(jmodel, params, jnp.asarray(feats), jnp.asarray(zs),
                  method=lambda m, f, z: m.decode(f, z))
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(feats), torch.from_numpy(zs))
    assert tuple(got.shape) == tuple(want.shape)
    assert_close(got, want, RTOL, ATOL, "fcomb")


def test_encode_decode_match(models):
    """``encode`` then ``decode`` of posterior draws with shared numpy noise."""
    jmodel, params, tmodel = models
    x, y = _inputs(3)
    eps = np.random.default_rng(4).standard_normal((5, 2, TINY["latent_dim"])).astype(np.float32)

    def jax_path(m, a, t, e):
        feats, prior, post = m.encode(a, t)
        zs = post.mu + post.sigma * e
        return feats, prior, post, m.decode(feats, zs)

    jf, jprior, jpost, jens = _apply(jmodel, params, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(eps), method=jax_path)
    with torch.no_grad():
        tf, tprior, tpost = tmodel.encode(torch.from_numpy(x), torch.from_numpy(y))
        zs = tpost.rsample(eps=torch.from_numpy(eps), sample_shape=(5,))
        tens = tmodel.decode(tf, zs)
    assert_close(tf, jf, RTOL, ATOL, "features")
    assert_close(tprior.mu, jprior.mu, RTOL, ATOL, "prior mu")
    assert_close(tpost.log_sigma, jpost.log_sigma, RTOL, ATOL, "posterior log_sigma")
    assert tuple(tens.shape) == (2, 5, *TINY["img_resolution"], TINY["num_classes"])
    assert_close(tens, jens, RTOL, ATOL, "ensemble")



def test_distributions_match():
    """DiagGaussian.rsample with given noise, both KLs."""
    from probunet_tpu.ops import distributions as jd

    from probunet_tpu_torch.ops import distributions as td

    rng = np.random.default_rng(7)
    mu_q, ls_q, mu_p, ls_p = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(4))
    eps = rng.standard_normal((4, 3, 5)).astype(np.float32)
    jq, jp = jd.DiagGaussian(jnp.asarray(mu_q), jnp.asarray(ls_q)), jd.DiagGaussian(
        jnp.asarray(mu_p), jnp.asarray(ls_p))
    tq, tp = (td.DiagGaussian(torch.from_numpy(a), torch.from_numpy(b))
              for a, b in ((mu_q, ls_q), (mu_p, ls_p)))
    assert_close(tq.rsample(eps=torch.from_numpy(eps), sample_shape=(4,)),
                 jq.mu + jq.sigma * jnp.asarray(eps), 1e-6, 1e-6, "rsample")
    assert_close(td.kl_diag_gaussians(tq, tp), jd.kl_diag_gaussians(jq, jp), 1e-5, 1e-6, "kl")
    assert_close(td.kl_to_standard_normal(tq), jd.kl_to_standard_normal(jq), 1e-5, 1e-6,
                 "kl to N(0, I)")
    draw = tq.rsample(torch.Generator().manual_seed(0), (2,))
    assert tuple(draw.shape) == (2, 3, 5) and draw.dtype == torch.float32
    with pytest.raises(ValueError):
        tq.rsample()


@pytest.mark.parametrize("mode", ["xavier_uniform", "xavier_normal", "kaiming_uniform",
                                  "kaiming_normal"])
def test_edm_init_scales(mode):
    """Each EDM init mode draws with the JAX initializer's standard deviation."""
    from probunet_tpu_torch.models.layers import edm_init

    fan_in, fan_out, scale = 64, 32, 0.5
    w = edm_init(mode, fan_in, fan_out, scale, (256, 256), torch.Generator().manual_seed(0))
    var = {"xavier_uniform": 2 / (fan_in + fan_out), "xavier_normal": 2 / (fan_in + fan_out),
           "kaiming_uniform": 1 / fan_in, "kaiming_normal": 1 / fan_in}[mode]
    assert abs(float(w.std()) / (scale * var ** 0.5) - 1) < 0.02
    assert float(w.mean()) < 0.01
    zero = edm_init(mode, fan_in, fan_out, 0.0, (4,), torch.Generator())
    assert not bool(zero.any())


@pytest.mark.parametrize("num_filters,m,route", [((16, 16), 4, "unfused"),
                                                 ((32, 16), 33, "unfused"),
                                                 ((32, 16), 4, "fused")])
def test_fused_elbo_route_follows_the_kernel_shapes(monkeypatch, num_filters, m, route):
    """``elbo(fused=True)`` takes kernel A's route only where
    ``fcomb_crps.supported`` holds (Fcomb width 32, M <= 32, K <= 4), and
    the unfused route (``Fcomb.ensemble``, kernels B and B′) elsewhere, on
    the CPU as on the card. Either way the ELBO and every gradient match
    the JAX package's fused ELBO (``PROBUNET_FUSED_ELBO=1``), at the
    model-level tolerance."""
    from torch_parity import jax_elbo_grads

    from probunet_tpu_torch.convert import convert_params
    from probunet_tpu_torch.ops.kernels import fcomb_crps

    jmodel, params = jax_tiny_model(num_filters=num_filters)
    tmodel = torch_tiny_model(params, gn_impl="composed", num_filters=num_filters)
    x, y = _inputs(5)
    eps = np.random.default_rng(6).standard_normal(
        (m, 2, TINY["latent_dim"])).astype(np.float32)
    beta_1 = 0.7
    want_total, want_met, want_grads, _ = jax_elbo_grads(
        monkeypatch, jmodel, params, x, y, eps, "afcrps", True, beta_1, m, record=False)
    fused_calls = []
    fused_loss = fcomb_crps.fused_fcomb_crps_loss
    monkeypatch.setattr(fcomb_crps, "fused_fcomb_crps_loss",
                        lambda *a, **k: fused_calls.append(1) or fused_loss(*a, **k))
    total, met = tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y), M=m, beta_1=beta_1,
                             eps=torch.from_numpy(eps), fused=True)
    total.backward()
    assert ("fused" if fused_calls else "unfused") == route
    assert_close(total.detach(), want_total, RTOL, ATOL, "loss")
    assert_close(met["recon"].detach(), want_met["recon"], RTOL, ATOL, "recon")
    want = convert_params(want_grads, tmodel)
    for name, prm in tmodel.named_parameters():
        assert_close(prm.grad, want[name], RTOL, ATOL, f"d{name}")
