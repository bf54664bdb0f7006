"""The WMSE + MS-SSIM and L1 ELBOs, port against JAX: the training ELBO's
value, its metrics and every parameter gradient, dropout on, the U-Net's
GroupNorm chains on the composed route (torch composition + kernel D's
plain version against the JAX default under
``PROBUNET_DROPOUT_IMPL=pallas``), the posterior noise fed to both
packages (``torch_parity.jax_elbo_grads``; (M, B, D) for ``"mse+ssim"``,
(B, D) for ``"l1"``'s one draw) and the seed words each U-Net block hands
its dropout recorded from the JAX side.

``"mse+ssim"`` runs on a 128x128 tiny model (MS-SSIM at win_size 7 needs
sides above 96), ``"l1"`` on the 16x16 one with beta_2 > 0. f32, rtol 1e-4
/ atol 1e-5, the training tests' tolerance (the same sums in other orders
through ~20 layers, forward and back).
"""

import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close, jax_elbo_grads, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.convert import convert_params

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RTOL, ATOL = 1e-4, 1e-5
DROPOUT, B = 0.1, 2
ELBO_KW = dict(beta_2=0.3, alpha_w=0.01, beta_w=0.05, lam_w=0.4)


def _inputs(seed, res, m):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *res, TINY["input_channels"])).astype(np.float32)
    y = rng.standard_normal((B, *res, TINY["num_classes"])).astype(np.float32)
    shape = (B, TINY["latent_dim"]) if m is None else (m, B, TINY["latent_dim"])
    return x, y, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("loss_type,res,m", [("mse+ssim", (128, 128), 2),
                                             ("l1", TINY["img_resolution"], None)])
def test_training_elbo_matches_jax(monkeypatch, loss_type, res, m):
    jmodel, params = jax_tiny_model(dropout=DROPOUT, img_resolution=res)
    tmodel = torch_tiny_model(params, dropout=DROPOUT, gn_impl="composed", img_resolution=res)
    x, y, eps = _inputs(7, res, m)
    beta_1 = 0.6
    want_total, want_met, want_grads, seeds = jax_elbo_grads(
        monkeypatch, jmodel, params, x, y, eps, loss_type, True, beta_1, m or 1, **ELBO_KW)
    assert seeds.shape == (len(tmodel.unet.dropout_blocks), 2)
    total, met = tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y), M=m or 1,
                             loss_type=loss_type, beta_1=beta_1, eps=torch.from_numpy(eps),
                             training=True, seeds=torch.from_numpy(seeds), **ELBO_KW)
    total.backward()
    extra = ("wmse", "msssim") if loss_type == "mse+ssim" else ("recon_per_channel", "kl2_mean")
    assert set(met) == {"recon", "kl", "kl_mean", *extra}
    assert_close(total.detach(), want_total, RTOL, ATOL, "loss")
    for key in met:
        assert_close(met[key].detach(), want_met[key], RTOL, ATOL, key)
    want = convert_params(want_grads, tmodel)
    for name, prm in tmodel.named_parameters():
        assert prm.grad is not None, name
        assert_close(prm.grad, want[name], RTOL, ATOL, f"d{name}")


def test_ensemble_losses_need_two_members():
    _, params = jax_tiny_model()
    tmodel = torch_tiny_model(params)
    x, y, eps = _inputs(8, TINY["img_resolution"], 1)
    with pytest.raises(ValueError, match="M must be >= 2"):
        tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y), M=1, eps=torch.from_numpy(eps))


def test_mse_ssim_members_are_f32_under_bf16():
    """Under the bf16 compute dtype the WMSE + MS-SSIM ELBO scores f32
    members in both packages (the U-Net casts its output back to the
    input's dtype, so Fcomb decodes in f32): MS-SSIM's window and maps are
    f32 there."""
    import jax.numpy as jnp

    jmodel, params = jax_tiny_model("bfloat16")
    tmodel = torch_tiny_model(params, "bfloat16")
    h, w = TINY["img_resolution"]
    zs = np.zeros((3, B, TINY["latent_dim"]), np.float32)

    def members(m, x, z):
        feats, _, _ = m.encode(x)
        return m.fcomb.ensemble(feats, z)

    want = jmodel.apply({"params": params}, jnp.zeros((B, h, w, 3)), jnp.asarray(zs),
                        method=members)
    with torch.no_grad():
        got = tmodel.fcomb.ensemble(tmodel.unet(torch.zeros((B, h, w, 3))),
                                    torch.from_numpy(zs))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
