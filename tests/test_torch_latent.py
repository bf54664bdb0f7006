"""Latent exploration, port against JAX, on the tiny Probabilistic U-Net
(``torch_parity``, latent_dim 4) over 48 synthetic 16x16 days (CPU).

Both packages read the same HR stack (``ClimexDataset(hr=...)``,
``lrinterp_to_residuals``, 4x pooling). The JAX functions run eagerly
where they call the model outside ``jax.jit``, so the models are on the
composed GroupNorm route (the JAX default; the kernel route's U-Net is
held by ``test_torch_models.py``). ``collapse_diagnostics``' two draws
(probe 5's prior ensemble, probe 6's prior draw) are numpy noise: the JAX
``DiagGaussian.rsample`` is patched to return mu + sigma * that noise,
and the port takes it as ``eps_sample`` / ``eps_z``.

Tolerances: the PCA, the grids and their inversion are the same numpy
float64 code on the same input, so they must be equal bit for bit; the
latents and decodes f32 rtol 1e-5 of each array's largest value; the
probes rtol 1e-4 (differences and ratios of f32 decodes and gradients
amplify the decodes' 1e-6 relative differences), the output and target
means within 1e-4 of their std; the verdict equal.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import GN_ENV, TINY, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.analysis import latent as tlat

pytestmark = pytest.mark.usefixtures("torch_one_thread")

F32, PROBE = 1e-5, 1e-4
DAYS, MAX_ITEMS = 48, 32


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, JAX dataset, port model, port dataset)."""
    from probunet_tpu.data.climex import ClimexDataset as JDataset

    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields

    h, w = TINY["img_resolution"]
    hr = synthetic_climex_fields(DAYS, h, w, ("pr", "tasmin", "tasmax"), seed=4)
    kw = dict(years=range(1960, 1961), coords=(0, w, 0, h),
              pipeline="lrinterp_to_residuals", lowres_scale=4, hr=hr)
    jmodel, params = jax_tiny_model(seed=2)
    return (jmodel, params, JDataset(**kw), torch_tiny_model(params, gn_impl="composed"),
            ClimexDataset(**kw, device="cpu"))


@pytest.fixture()
def composed(monkeypatch):
    for k, v in GN_ENV["composed"].items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("d", [2, 6])
def test_pca_and_grids_are_exact(d):
    from probunet_tpu.analysis import latent as jlat

    rng = np.random.default_rng(d)
    z = (rng.standard_normal((200, d)) * np.arange(1, d + 1)).astype(np.float32)
    jp, tp = jlat.LatentPCA.fit(z), tlat.LatentPCA.fit(z)
    for field in jp._fields:
        assert np.array_equal(getattr(tp, field), getattr(jp, field)), field
    scores = tp.transform(z)
    assert np.array_equal(scores, jp.transform(z))
    assert np.array_equal(tp.inverse_transform(scores), jp.inverse_transform(scores))
    for name, args in (("pc_grid_deciles", (scores, 10)), ("pc_grid_sigma", (scores, 7))):
        grid = getattr(tlat, name)(*args)
        assert np.array_equal(grid, getattr(jlat, name)(*args)), name
        assert np.array_equal(tlat.grid_to_z(tp, grid, fill_scores=scores),
                              jlat.grid_to_z(jp, grid, fill_scores=scores)), name
        assert np.array_equal(tlat.grid_to_z(tp, grid), jlat.grid_to_z(jp, grid)), name


@pytest.mark.parametrize("posterior", [False, True], ids=["prior", "posterior"])
def test_collect_latents(pair, composed, posterior):
    """Batches of 10 over 32 items: the last batch partial."""
    from probunet_tpu.analysis import latent as jlat

    jmodel, params, jds, tmodel, tds = pair
    want = jlat.collect_latents(jmodel, params, jds, batch_size=10, use_posterior=posterior,
                                max_items=MAX_ITEMS)
    got = tlat.collect_latents(tmodel, tds, batch_size=10, use_posterior=posterior,
                               max_items=MAX_ITEMS)
    for k in ("mu", "sigma"):
        assert got[k].shape == (MAX_ITEMS, TINY["latent_dim"]) and got[k].dtype == np.float32
        _close(got[k], want[k], F32, k)


def test_decode_latent_grid(pair, composed):
    """Fcomb-only decodes of 13 z vectors in chunks of 5 against item 3's
    frozen features."""
    from probunet_tpu.analysis import latent as jlat

    jmodel, params, jds, tmodel, tds = pair
    zs = np.random.default_rng(5).standard_normal((13, TINY["latent_dim"])) * 2
    jfeats, _, _ = jmodel.apply({"params": params},
                                jds.preprocess(jnp.asarray(jds.get_hr_batch([3])))["inputs"],
                                method=type(jmodel).encode)
    want = jlat.decode_latent_grid(jmodel, params, jfeats, zs, batch=5)
    with torch.no_grad():
        feats, _, _ = tmodel.encode(tds.preprocess(torch.from_numpy(
            tds.get_hr_batch(np.array([3]))))["inputs"])
    got = tlat.decode_latent_grid(tmodel, feats, zs, batch=5)
    assert got.shape == (13, 16, 16, TINY["num_classes"])
    _close(got, want, F32, "decode")


def _probe_noise(n_contexts, num_samples=16):
    rng = np.random.default_rng(n_contexts)
    d = TINY["latent_dim"]
    return (rng.standard_normal((num_samples, n_contexts, d)).astype(np.float32),
            rng.standard_normal((n_contexts, d)).astype(np.float32))


@pytest.fixture(scope="module")
def diagnostics(pair):
    """{n_contexts: (JAX diagnostics, the port's)} at 1 and 4 contexts."""
    from probunet_tpu.analysis import latent as jlat
    from probunet_tpu.ops import distributions as jd

    jmodel, params, jds, tmodel, tds = pair
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in GN_ENV["composed"].items():
            mp.setenv(k, v)
        for n in (1, 4):
            eps_sample, eps_z = _probe_noise(n)
            mp.setattr(jd.DiagGaussian, "rsample",
                       lambda self, key, sample_shape=(), a=eps_sample, b=eps_z:
                       self.mu + self.sigma * jnp.asarray(a if sample_shape else b))
            want = jlat.collapse_diagnostics(jmodel, params, jds, batch_size=10,
                                             max_items=MAX_ITEMS, n_contexts=n)
            got = tlat.collapse_diagnostics(tmodel, tds, batch_size=10, max_items=MAX_ITEMS,
                                            n_contexts=n, eps_sample=torch.from_numpy(eps_sample),
                                            eps_z=torch.from_numpy(eps_z))
            out[n] = (want, got)
    return out


@pytest.mark.parametrize("n_contexts", [1, 4])
def test_collapse_diagnostics_field_by_field(diagnostics, n_contexts):
    want, got = diagnostics[n_contexts]
    assert set(got) == set(want)
    assert got["latent_dim"] == want["latent_dim"] == TINY["latent_dim"]
    assert got["n_contexts"] == want["n_contexts"] == n_contexts
    assert got["collapsed"] == want["collapsed"]
    for key in ("prior_sigma_spectrum", "prior_mu_spread"):
        _close(got[key], want[key], F32, key)
    for key in ("extreme_z_delta", "z_sensitivity", "fcomb_feat_weight_norm",
                "fcomb_z_weight_norm", "sample_variance_ratio",
                "sample_variance_ratio_per_context", "grad_ratio_z_over_feat",
                "fcomb_activation_feat", "fcomb_activation_z", "kl_q_p"):
        _close(got[key], want[key], PROBE, key)
    assert set(got["ablation_mean_abs"]) == set(want["ablation_mean_abs"])
    for k, v in want["ablation_mean_abs"].items():
        _close(got["ablation_mean_abs"][k], v, PROBE, f"ablation/{k}")
    # a mean is a sum of values of the size of the std: held to the std
    # (the standardized targets' mean is 0 up to rounding)
    for group in ("output_stats", "target_stats"):
        assert set(got[group]) == set(want[group]) == {"mean", "std"}
        std = want[group]["std"]
        _close(got[group]["std"], std, PROBE, f"{group}/std")
        assert abs(got[group]["mean"] - want[group]["mean"]) <= PROBE * std, group


def test_format_summary_and_artifacts(diagnostics, tmp_path):
    """The report's text is the JAX function's on the same dict, and the
    artifact pickle has the JAX keys."""
    from probunet_tpu.analysis import latent as jlat

    _, got = diagnostics[4]
    text = tlat.format_summary(got)
    assert text == jlat.format_summary(got)
    assert text.splitlines()[-1].startswith("VERDICT")
    z = np.random.default_rng(0).standard_normal((40, 4))
    lat = {"mu": z, "sigma": np.abs(z)}
    tlat.save_artifacts(str(tmp_path / "t.pkl"), tlat.LatentPCA.fit(z), lat, got)
    jlat.save_artifacts(str(tmp_path / "j.pkl"), jlat.LatentPCA.fit(z), lat, got)
    with open(tmp_path / "t.pkl", "rb") as f:
        t = pickle.load(f)
    with open(tmp_path / "j.pkl", "rb") as f:
        j = pickle.load(f)
    assert set(t) == set(j) == {"pca", "latents", "diagnostics"}
    assert set(t["pca"]) == set(j["pca"])
    for k in j["pca"]:
        assert np.array_equal(t["pca"][k], j["pca"][k]), k


def test_single_prior_sweep(pair, composed):
    from probunet_tpu.analysis import latent as jlat

    jmodel, params, jds, tmodel, tds = pair
    want = jlat.single_prior_sweep(jmodel, params, jds, item=5, n=3, span=6.0)
    got = tlat.single_prior_sweep(tmodel, tds, item=5, n=3, span=6.0)
    assert np.array_equal(got["dims"], want["dims"])
    assert got["decoded"].shape == (3, 3, 16, 16, TINY["num_classes"])
    for k in ("sigma", "grid_z", "decoded", "center"):
        _close(got[k], want[k], F32, k)
