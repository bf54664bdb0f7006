"""The serve slice as a whole, port against JAX, on one seeded batch.

Eval ELBO: preprocess_batch -> encode -> zs = mu + sigma * eps (numpy eps)
-> fused recon (fcomb-CRPS, plain version vs the Pallas kernel in
interpret mode) and unfused recon (Fcomb.ensemble + afCRPS/CRPS terms) ->
total = recon + beta_1 * KL.

Prior ensemble: decode -> residual_to_hr -> invert_physical_transform ->
EvalAccumulator.update / update_hist / result.

Both on the composed GroupNorm route against the JAX default, and, for
the ELBO and the ensemble, on the kernel route (kernel C's plain version)
against the JAX package under ``PROBUNET_GN_IMPL=pallas``.

f32, rtol 1e-4 / atol 1e-5: the model-level tolerance of
test_torch_models.py carried through the loss; metrics of identical inputs
match to 1e-5 and their histograms exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import GN_ENV, TINY, assert_close, jax_tiny_model, torch_tiny_model

from probunet_tpu_torch.data import climex as tclimex
from probunet_tpu_torch.data import transforms as ttransforms
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.evals.streaming import EvalAccumulator as TorchAcc
from probunet_tpu_torch.ops.kernels import fused_gn as tgn
from probunet_tpu_torch.train.loop import eval_model, make_eval_step

RTOL, ATOL = 1e-4, 1e-5
K_LOW, PIPE, M, B = 4, "lrinterp_to_residuals", 4, 3


@pytest.fixture(scope="module")
def setup():
    from probunet_tpu.data import climex as jc
    from probunet_tpu.data.transforms import apply_physical_transform

    jmodel, params = jax_tiny_model()
    tmodel = torch_tiny_model(params, gn_impl="composed")
    phys = synthetic_climex_fields(2 * B, *TINY["img_resolution"], seed=5)
    stored = np.array(apply_physical_transform(jnp.asarray(phys)))  # writable copy
    jstats = jc.compute_stats(jnp.asarray(stored), K_LOW)
    tstats = tclimex.compute_stats(torch.from_numpy(stored), K_LOW)
    return jmodel, params, tmodel, stored, jstats, tstats


def _eps(seed, m=M):
    return np.random.default_rng(seed).standard_normal(
        (m, B, TINY["latent_dim"])).astype(np.float32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("loss_type", ["afcrps", "crps"])
def test_eval_elbo_matches_jax(setup, loss_type, fused):
    from probunet_tpu.data import climex as jc
    from probunet_tpu.ops.distributions import kl_diag_gaussians
    from probunet_tpu.ops.losses import afcrps_loss, crps_loss
    from probunet_tpu.ops.pallas.fcomb_crps import fused_fcomb_crps_loss

    jmodel, params, tmodel, stored, jstats, tstats = setup
    hr, eps, beta_1 = stored[:B], _eps(1), 0.5
    jb = jc.preprocess_batch(jnp.asarray(hr), jstats, PIPE, K_LOW)

    def jax_elbo(m, x, y, e):
        feats, prior, post = m.encode(x, y)
        zs = post.mu + post.sigma * e
        if fused:
            recon = fused_fcomb_crps_loss(feats, zs, m.fcomb.variables["params"], y,
                                          loss_type, compute_dtype="float32")
        else:
            ens = m.decode(feats, zs)
            recon = afcrps_loss(ens, y) if loss_type == "afcrps" else crps_loss(ens, y)
        kl = kl_diag_gaussians(post, prior)
        return recon + beta_1 * kl.mean(), recon, kl

    want = jmodel.apply({"params": params}, jb["inputs"], jb["targets"], jnp.asarray(eps),
                        method=jax_elbo)
    tb = tclimex.preprocess_batch(torch.from_numpy(hr), tstats, PIPE, K_LOW)
    with torch.no_grad():
        total, met = tmodel.elbo(tb["inputs"], tb["targets"], M=M, loss_type=loss_type,
                                 beta_1=beta_1, eps=torch.from_numpy(eps), fused=fused)
    assert_close(met["recon"], want[1], RTOL, ATOL, "recon")
    assert_close(met["kl"], want[2], RTOL, ATOL, "kl")
    assert_close(total, want[0], RTOL, ATOL, "total")


def test_eval_step_and_eval_model(setup):
    """make_eval_step draws the posterior noise from the generator it is
    given; eval_model averages its metrics over the batches."""
    from probunet_tpu_torch.config import preset

    _, _, tmodel, stored, _, tstats = setup
    cfg = preset("probunet_multivar_128")
    cfg.data.lowres_scale = K_LOW
    cfg.train.eval_ensemble_size = M
    step = make_eval_step(tmodel, cfg, fused=True)
    hr = torch.from_numpy(stored[:B])
    got = step(hr, tstats, torch.Generator().manual_seed(3))
    tb = tclimex.preprocess_batch(hr, tstats, PIPE, K_LOW)
    with torch.no_grad():
        _, _, post = tmodel.encode(tb["inputs"], tb["targets"])
        eps = torch.randn((M, *post.mu.shape), generator=torch.Generator().manual_seed(3))
        total, met = tmodel.elbo(tb["inputs"], tb["targets"], M=M, eps=eps)
    assert float(got["loss"]) == float(total) == float(got["recon"])  # beta_1 = 0
    assert float(got["kl_mean"]) == float(met["kl_mean"])
    from probunet_tpu_torch.train.state import TrainState

    cfg.train.batch_size = B
    ds = tclimex.ClimexDataset(hr=stored, lowres_scale=K_LOW, device="cpu")
    out = eval_model(step, TrainState(model=tmodel, optimizer=None), ds, tstats, cfg)
    assert np.isfinite(out["recon"]) and out["kl"] > 0


@pytest.fixture(scope="module")
def kernel_route(setup):
    """The JAX model's encode of one batch under PROBUNET_GN_IMPL=pallas,
    traced and compiled once (an eager run interprets the Pallas kernel
    call by call), and the port's model on the kernel route."""
    import jax

    from probunet_tpu.data import climex as jc

    jmodel, params, _, stored, jstats, tstats = setup
    jb = jc.preprocess_batch(jnp.asarray(stored[:B]), jstats, PIPE, K_LOW)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in GN_ENV["kernel"].items():
            mp.setenv(k, v)
        encoded = jax.jit(lambda p, x, y: jmodel.apply(
            {"params": p}, x, y, method=lambda m, a, t: m.encode(a, t)))(
                params, jb["inputs"], jb["targets"])
    tb = tclimex.preprocess_batch(torch.from_numpy(stored[:B]), tstats, PIPE, K_LOW)
    return encoded, tb, torch_tiny_model(params, gn_impl="kernel")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("loss_type", ["afcrps", "crps"])
def test_eval_elbo_matches_jax_kernel_route(setup, kernel_route, loss_type, fused):
    from probunet_tpu.ops.distributions import kl_diag_gaussians
    from probunet_tpu.ops.losses import afcrps_loss, crps_loss
    from probunet_tpu.ops.pallas.fcomb_crps import fused_fcomb_crps_loss

    jmodel, params = setup[:2]
    (feats, prior, post), tb, tmodel = kernel_route
    eps, beta_1 = _eps(1), 0.5
    zs = post.mu + post.sigma * jnp.asarray(eps)
    y = jnp.asarray(tb["targets"].numpy())
    if fused:
        recon = jmodel.apply({"params": params}, feats, zs, y, method=lambda m, f, z, t:
                             fused_fcomb_crps_loss(f, z, m.fcomb.variables["params"], t,
                                                   loss_type, compute_dtype="float32"))
    else:
        ens = jmodel.apply({"params": params}, feats, zs, method=lambda m, f, z: m.decode(f, z))
        recon = afcrps_loss(ens, y) if loss_type == "afcrps" else crps_loss(ens, y)
    kl = kl_diag_gaussians(post, prior)
    before = tgn.gn_film_silu_dropout.launches
    with torch.no_grad():
        total, met = tmodel.elbo(tb["inputs"], tb["targets"], M=M, loss_type=loss_type,
                                 beta_1=beta_1, eps=torch.from_numpy(eps), fused=fused)
    assert tgn.gn_film_silu_dropout.launches == before  # CPU: the plain version
    assert_close(met["recon"], recon, RTOL, ATOL, "recon")
    assert_close(met["kl"], kl, RTOL, ATOL, "kl")
    assert_close(total, recon + beta_1 * kl.mean(), RTOL, ATOL, "total")


def test_prior_ensemble_matches_jax_kernel_route(setup, kernel_route):
    """``sample`` (shared U-Net features, prior draws from numpy noise)."""
    jmodel, params = setup[:2]
    (feats, prior, _), tb, tmodel = kernel_route
    eps = _eps(10)
    want = jmodel.apply({"params": params}, feats, prior.mu + prior.sigma * jnp.asarray(eps),
                        method=lambda m, f, z: m.decode(f, z))
    with torch.no_grad():
        got = tmodel.sample(tb["inputs"], M, eps=torch.from_numpy(eps))
    assert tuple(got.shape) == (B, M, *TINY["img_resolution"], 3)
    assert_close(got, want, RTOL, ATOL, "ensemble")


def _compare_results(got, want, rtol, atol, hist_exact):
    assert got["items"] == want["items"]
    for key in ("crps", "mae"):
        for part in ("mean", "std", "per_timestep"):
            assert_close(got[key][part], want[key][part], rtol, atol, f"{key} {part}")
    for key in ("spread", "psd_gt", "psd_model"):
        assert_close(got[key], want[key], rtol, atol, key)
    for key in ("centers", "lo", "hi"):
        assert_close(got["hist"][key], want["hist"][key], rtol, atol, f"hist {key}")
    if hist_exact:
        for key in ("gt_counts", "model_counts"):
            assert np.array_equal(got["hist"][key], want["hist"][key]), key


def test_prior_ensemble_eval_matches_jax(setup):
    from probunet_tpu.data import climex as jc
    from probunet_tpu.data.transforms import invert_physical_transform
    from probunet_tpu.evals.streaming import EvalAccumulator as JaxAcc

    jmodel, params, tmodel, stored, jstats, tstats = setup
    jacc, tacc, same_input_acc = JaxAcc(hist_bins=20), TorchAcc(20), TorchAcc(20)
    fields = []
    for i in range(2):
        hr = stored[i * B:(i + 1) * B]
        eps = _eps(10 + i)
        jb = jc.preprocess_batch(jnp.asarray(hr), jstats, PIPE, K_LOW)

        def jax_sample(m, x, e):
            feats, prior, _ = m.encode(x)
            return m.decode(feats, prior.mu + prior.sigma * e)

        jens = jmodel.apply({"params": params}, jb["inputs"], jnp.asarray(eps),
                            method=jax_sample)
        jpred = invert_physical_transform(
            jc.residual_to_hr(jens, jb["lrinterp"][:, None], jstats, PIPE))
        jgt = invert_physical_transform(jb["hr"])

        tb = tclimex.preprocess_batch(torch.from_numpy(hr), tstats, PIPE, K_LOW)
        with torch.no_grad():
            tens = tmodel.sample(tb["inputs"], M, eps=torch.from_numpy(eps))
        lri = tclimex.lrinterp_from_batch(tb, K_LOW)
        tpred = ttransforms.invert_physical_transform(
            tclimex.residual_to_hr(tens, lri[:, None], tstats, PIPE))
        tgt = ttransforms.invert_physical_transform(tb["hr"])
        assert tuple(tpred.shape) == (B, M, *TINY["img_resolution"], 3)
        assert_close(tpred, jpred, RTOL, 1e-4, "ensemble in physical units")

        jacc.update(jpred, jgt)
        tacc.update(tpred, tgt)
        same_input_acc.update(torch.from_numpy(np.array(jpred)),
                              torch.from_numpy(np.array(jgt)))
        fields.append((jpred, jgt, tpred, tgt))
    for jpred, jgt, tpred, tgt in fields:  # pass 2 on the pass-1 range
        jacc.update_hist(jpred, jgt)
        tacc.update_hist(tpred, tgt)
        same_input_acc.update_hist(torch.from_numpy(np.array(jpred)),
                                   torch.from_numpy(np.array(jgt)))
    want = jacc.result()
    _compare_results(same_input_acc.result(), want, 1e-5, 1e-6, hist_exact=True)
    _compare_results(tacc.result(), want, RTOL, 1e-4, hist_exact=False)
