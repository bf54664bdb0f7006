"""Latent-space exploration: collection, PCA, grid decode, collapse probes
(port of ``probunet_tpu/analysis/latent.py``).

- :func:`collect_latents`: the prior (or posterior) mu and sigma over a
  dataset, batch by batch (the encoders alone: the U-Net's features are
  not needed);
- :class:`LatentPCA`: StandardScaler + SVD PCA in numpy float64, a copy
  of the JAX package's (the same SVD, so the same signs);
- :func:`pc_grid_deciles`, :func:`pc_grid_sigma`, :func:`grid_to_z`: PC1 x
  PC2 grids inverted back to z-space;
- :func:`decode_latent_grid`: Fcomb-only decodes against the frozen
  U-Net features of one context;
- :func:`collapse_diagnostics`: the ten latent-collapse probes, with
  :func:`format_summary` (the summary.txt text) and :func:`save_artifacts`
  (the pca_artifacts.pkl keys);
- :func:`single_prior_sweep`: the top-2 highest-sigma dims of one sample
  swept over +-span sigma.

The model's device is the dataset's (``dataset.device``). The collapse
probes' draws (probe 5's prior ensemble, probe 6's prior draw) are the
explicit ``eps_sample`` / ``eps_z``, or drawn from a CPU generator seeded
with ``seed``, so the card and the CPU probe with the same numbers; they
are not the JAX package's.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.ops.distributions import kl_diag_gaussians


def _hr_batch(dataset, idx: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(dataset.get_hr_batch(idx)).to(dataset.device)


# ---------------------------------------------------------------------------
# Latent collection
# ---------------------------------------------------------------------------

@torch.no_grad()
def collect_latents(model: ProbabilisticUNet, dataset, batch_size: int = 64,
                    use_posterior: bool = False,
                    max_items: int | None = None) -> dict[str, np.ndarray]:
    """Prior (or posterior, which also encodes the target residual) mu and
    sigma over the first ``max_items`` items of a dataset -> {"mu": (N, D),
    "sigma": (N, D)} float32; the last batch may be partial."""
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    mus, sigmas = [], []
    for i in range(0, n, batch_size):
        batch = dataset.preprocess(_hr_batch(dataset, np.arange(i, min(i + batch_size, n))))
        dist = (model.posterior(batch["inputs"], batch["targets"]) if use_posterior
                else model.prior(batch["inputs"]))
        mus.append(dist.mu.cpu().numpy())
        sigmas.append(dist.sigma.cpu().numpy())
    return {"mu": np.concatenate(mus), "sigma": np.concatenate(sigmas)}


# ---------------------------------------------------------------------------
# PCA (StandardScaler + SVD)
# ---------------------------------------------------------------------------

class LatentPCA(NamedTuple):
    """StandardScaler + full PCA of latent means. With D <= 2 the
    components are the raw axes."""

    mean: np.ndarray        # (D,) scaler mean
    std: np.ndarray         # (D,) scaler std
    components: np.ndarray  # (D, D) rows = principal axes in scaled space
    explained_variance_ratio: np.ndarray  # (D,)

    @classmethod
    def fit(cls, z: np.ndarray, whiten_eps: float = 1e-12) -> "LatentPCA":
        z = np.asarray(z, dtype=np.float64)
        mean = z.mean(axis=0)
        std = z.std(axis=0) + whiten_eps
        zs = (z - mean) / std
        d = z.shape[1]
        if d <= 2:
            comps = np.eye(d)
            var = zs.var(axis=0)
        else:
            # SVD PCA: rows of vt are principal axes
            _, s, vt = np.linalg.svd(zs - zs.mean(axis=0), full_matrices=False)
            comps = vt
            var = (s ** 2) / max(1, (zs.shape[0] - 1))
        ratio = var / var.sum() if var.sum() > 0 else np.zeros_like(var)
        return cls(mean, std, comps, ratio)

    def transform(self, z: np.ndarray) -> np.ndarray:
        zs = (np.asarray(z, np.float64) - self.mean) / self.std
        return zs @ self.components.T

    def inverse_transform(self, scores: np.ndarray) -> np.ndarray:
        zs = np.asarray(scores, np.float64) @ self.components
        return zs * self.std + self.mean


def pc_grid_deciles(scores: np.ndarray, n: int = 10) -> np.ndarray:
    """(n, n, 2) grid of (PC1, PC2) points at the marginal quantiles
    0.05 .. 0.95."""
    qs = np.linspace(0.05, 0.95, n)
    p1 = np.quantile(scores[:, 0], qs)
    p2 = np.quantile(scores[:, 1], qs)
    g1, g2 = np.meshgrid(p1, p2, indexing="ij")
    return np.stack([g1, g2], axis=-1)


def pc_grid_sigma(scores: np.ndarray, n: int = 7, k: float = 3.0) -> np.ndarray:
    """(n, n, 2) grid spanning +-k standard deviations of PC1 and PC2."""
    s1, s2 = scores[:, 0].std(), scores[:, 1].std()
    m1, m2 = scores[:, 0].mean(), scores[:, 1].mean()
    a = np.linspace(-k, k, n)
    g1, g2 = np.meshgrid(m1 + a * s1, m2 + a * s2, indexing="ij")
    return np.stack([g1, g2], axis=-1)


def grid_to_z(pca: LatentPCA, grid: np.ndarray, fill_scores=None) -> np.ndarray:
    """Invert an (n, n, 2) PC grid to z-space, the other PCs at 0 (or at
    the mean of ``fill_scores``). Returns (n * n, D)."""
    n1, n2, _ = grid.shape
    d = pca.components.shape[0]
    scores = np.zeros((n1 * n2, d))
    if fill_scores is not None:
        scores[:] = np.asarray(fill_scores).mean(axis=0)
    scores[:, 0] = grid[..., 0].reshape(-1)
    scores[:, 1] = grid[..., 1].reshape(-1)
    return pca.inverse_transform(scores)


# ---------------------------------------------------------------------------
# Grid decode against frozen features
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_latent_grid(model: ProbabilisticUNet, feats0: torch.Tensor, zs: np.ndarray,
                       batch: int = 64) -> np.ndarray:
    """Decode many z vectors against the frozen U-Net features of one
    context: feats0 (1, H, W, C) on the model's device, zs (N, D) ->
    residual-space decodes (N, H, W, num_classes), float32 numpy."""
    zs = np.asarray(zs, np.float32)
    outs = []
    for i in range(0, zs.shape[0], batch):
        z = torch.from_numpy(zs[i:i + batch]).to(feats0.device)
        outs.append(model.decode(feats0, z[:, None, :])[0].cpu().numpy())
    return np.concatenate(outs)


# ---------------------------------------------------------------------------
# Collapse diagnostics (the ten probes)
# ---------------------------------------------------------------------------

def collapse_diagnostics(model: ProbabilisticUNet, dataset, batch_size: int = 32,
                         num_samples: int = 16, max_items: int | None = 256, seed: int = 0,
                         n_contexts: int = 32, eps_sample: torch.Tensor | None = None,
                         eps_z: torch.Tensor | None = None) -> dict:
    """The latent-collapse probe battery on a trained model; a dict of
    scalars and vectors (:func:`format_summary` writes the report):

      1. prior sigma spectrum and mu spread over the first ``max_items``
      2. extreme-z decode range (z = mu +- 10 sigma against z = mu)
      3. per-dim z-sensitivity
      4. Fcomb's first-layer weight norms, feature block against z block
      5. prior-ensemble variance over target variance (``num_samples``)
      6. 4-way feature/latent ablation
      7. output-against-target mean and std
      8. RMS gradient of sum(decode^2) w.r.t. z over that w.r.t. the features
      9. Fcomb's first-layer activation scale, features against z
     10. mean KL(q || p)

    Probes 5-10 run over ``n_contexts`` items spread evenly over the
    dataset (or its ``max_items`` cap); probes 2-3 decode against context
    0's features. ``eps_sample`` (num_samples, N, D) and ``eps_z`` (N, D)
    are the probes' unit normal draws, else drawn in that order from a
    CPU generator seeded with ``seed``."""
    lat = collect_latents(model, dataset, batch_size, use_posterior=False,
                          max_items=max_items)
    sigma_spectrum = lat["sigma"].mean(axis=0)           # (D,)
    mu_spread = lat["mu"].std(axis=0)                    # (D,)

    n_avail = len(dataset) if max_items is None else min(max_items, len(dataset))
    n_contexts = max(1, min(n_contexts, n_avail))
    idxs = np.unique(np.linspace(0, n_avail - 1, n_contexts).astype(int))
    batch = dataset.preprocess(_hr_batch(dataset, idxs))
    x, y = batch["inputs"], batch["targets"]
    n = len(idxs)

    if eps_sample is None or eps_z is None:
        gen = torch.Generator().manual_seed(seed)
        d_lat = lat["mu"].shape[1]
        drawn_sample = torch.randn((num_samples, n, d_lat), generator=gen)
        drawn_z = torch.randn((n, d_lat), generator=gen)
        eps_sample = drawn_sample if eps_sample is None else eps_sample
        eps_z = drawn_z if eps_z is None else eps_z
    eps_sample, eps_z = eps_sample.to(x.device), eps_z.to(x.device)

    with torch.no_grad():
        feats, prior, post = model.encode(x, y)
    feats0 = feats[:1]
    mu0 = prior.mu[0].cpu().numpy()
    sig0 = prior.sigma[0].cpu().numpy()
    d = mu0.shape[0]

    def decode(zs):
        return decode_latent_grid(model, feats0, zs)

    # 2. extreme-z decode: output range at z = mu +- 10 sigma against z = mu
    dec_center = decode(mu0[None])
    dec_extreme = decode(np.stack([mu0 + 10 * sig0, mu0 - 10 * sig0]))
    extreme_delta = float(np.abs(dec_extreme - dec_center).max())

    # 3. per-dim sensitivity: |decode(mu + sigma_d e_d) - decode(mu)|
    z_pert = np.repeat(mu0[None], d, axis=0)
    z_pert[np.arange(d), np.arange(d)] += sig0
    sens = np.abs(decode(z_pert) - dec_center).mean(axis=(1, 2, 3))  # (D,)

    # 4. Fcomb's first-layer weight norms, feature block against z block
    w1 = model.fcomb.layer0_weight.detach()
    c = w1.shape[0] - d
    w1n = w1.cpu().numpy()
    feat_w_norm = float(np.linalg.norm(w1n[:c]) / np.sqrt(c))
    z_w_norm = float(np.linalg.norm(w1n[c:]) / np.sqrt(d))

    with torch.no_grad():
        # 5. per-context prior-ensemble variance over target variance
        # (N, M, H, W, K); statistics in f32 whatever the compute dtype
        samples = model.sample(x, num_samples, eps=eps_sample).float()
        var_per_ctx = (samples.std(dim=1, correction=1) ** 2).mean(dim=(1, 2, 3)).cpu().numpy()
        tgt_var_per_ctx = y.reshape(n, -1).var(dim=1, correction=0).cpu().numpy()
        ratio_per_ctx = var_per_ctx / np.maximum(tgt_var_per_ctx, 1e-12)
        var_ratio = float(var_per_ctx.mean() / max(tgt_var_per_ctx.mean(), 1e-12))

        # 6. 4-way ablation {feats, 0} x {z, 0}, each context its own prior draw
        z_samp = prior.rsample(eps=eps_z)                           # (N, D)
        zeros_f, zeros_z = torch.zeros_like(feats), torch.zeros_like(z_samp)
        dec = {"feat_z": model.decode(feats, z_samp),
               "feat_z0": model.decode(feats, zeros_z),
               "feat0_z": model.decode(zeros_f, z_samp),
               "feat0_z0": model.decode(zeros_f, zeros_z)}
        ablation = {k: float(np.abs(v.cpu().numpy()).mean()) for k, v in dec.items()}

        # 7. output-against-target statistics
        out_mean, out_std = float(samples.mean()), float(samples.std(correction=0))
        tgt_mean, tgt_std = float(y.mean()), float(y.std(correction=0))

    # 8. RMS gradient ratio ||d out / d z|| against ||d out / d feats||
    f_req = feats.detach().requires_grad_()
    z_req = z_samp.detach().requires_grad_()
    with torch.enable_grad():
        gf, gz = torch.autograd.grad((model.decode(f_req, z_req) ** 2).sum(), (f_req, z_req))
    grad_feat = float(torch.linalg.vector_norm(gf)) / np.sqrt(gf.numel())
    grad_z = float(torch.linalg.vector_norm(gz)) / np.sqrt(gz.numel())
    grad_ratio = grad_z / max(grad_feat, 1e-12)

    with torch.no_grad():
        # 9. Fcomb's first-layer activation scale: features against z
        feat_act = float(torch.abs(feats.float() @ w1[:c]).mean())
        z_act = float(torch.abs(z_samp.float() @ w1[c:]).mean())
        # 10. mean KL(q || p) over the probe set
        kl0 = float(kl_diag_gaussians(post, prior).mean())

    return {
        "latent_dim": d,
        "n_contexts": int(n),
        "prior_sigma_spectrum": sigma_spectrum,
        "prior_mu_spread": mu_spread,
        "extreme_z_delta": extreme_delta,
        "z_sensitivity": sens,
        "fcomb_feat_weight_norm": feat_w_norm,
        "fcomb_z_weight_norm": z_w_norm,
        "sample_variance_ratio": var_ratio,
        "sample_variance_ratio_per_context": ratio_per_ctx,
        "ablation_mean_abs": ablation,
        "output_stats": {"mean": out_mean, "std": out_std},
        "target_stats": {"mean": tgt_mean, "std": tgt_std},
        "grad_ratio_z_over_feat": grad_ratio,
        "fcomb_activation_feat": feat_act,
        "fcomb_activation_z": z_act,
        "kl_q_p": kl0,
        "collapsed": bool(var_ratio < 1e-3 or grad_ratio < 1e-4 or extreme_delta < 1e-5),
    }


def format_summary(diag: dict) -> str:
    """The human-readable collapse report (summary.txt), the JAX
    package's text."""
    lines = [
        "latent collapse diagnostics",
        "=" * 40,
        f"latent_dim                 : {diag['latent_dim']}",
        f"probe contexts             : {diag.get('n_contexts', 1)}",
        f"prior sigma (mean/min/max) : "
        f"{diag['prior_sigma_spectrum'].mean():.4g} / "
        f"{diag['prior_sigma_spectrum'].min():.4g} / "
        f"{diag['prior_sigma_spectrum'].max():.4g}",
        f"prior mu spread (mean)     : {diag['prior_mu_spread'].mean():.4g}",
        f"extreme-z output delta     : {diag['extreme_z_delta']:.4g}",
        f"z sensitivity (mean/max)   : {diag['z_sensitivity'].mean():.4g} / "
        f"{diag['z_sensitivity'].max():.4g}",
        f"fcomb weight norm feat/z   : {diag['fcomb_feat_weight_norm']:.4g} / "
        f"{diag['fcomb_z_weight_norm']:.4g}",
        f"sample/target var ratio    : {diag['sample_variance_ratio']:.4g}"
        + (
            "  (per-context min/max "
            f"{np.min(diag['sample_variance_ratio_per_context']):.3g}/"
            f"{np.max(diag['sample_variance_ratio_per_context']):.3g})"
            if "sample_variance_ratio_per_context" in diag else ""
        ),
        f"grad ratio (z/feat)        : {diag['grad_ratio_z_over_feat']:.4g}",
        f"fcomb activation feat/z    : {diag['fcomb_activation_feat']:.4g} / "
        f"{diag['fcomb_activation_z']:.4g}",
        f"KL(q||p) probe context     : {diag['kl_q_p']:.4g}",
        "ablation mean|out|:",
    ]
    for k, v in diag["ablation_mean_abs"].items():
        lines.append(f"  {k:10s}: {v:.4g}")
    lines.append(
        "VERDICT: LATENT COLLAPSE SUSPECTED" if diag["collapsed"]
        else "VERDICT: latent space active"
    )
    return "\n".join(lines)


def save_artifacts(path: str, pca: LatentPCA, latents: dict, diag: dict) -> None:
    """Pickle {"pca": the PCA's fields, "latents", "diagnostics"}: the
    pca_artifacts.pkl of the JAX package."""
    with open(path, "wb") as f:
        pickle.dump({"pca": pca._asdict(), "latents": latents, "diagnostics": diag}, f)


# ---------------------------------------------------------------------------
# Single-sample prior sweep
# ---------------------------------------------------------------------------

def single_prior_sweep(model: ProbabilisticUNet, dataset, item: int = 0, n: int = 6,
                       span: float = 6.0) -> dict:
    """Sweep the top-2 highest-sigma latent dims of one sample over
    +-span sigma, the others at mu. Returns {"dims", "sigma", "grid_z",
    "decoded" (n, n, H, W, K) residual fields, "center" (the decode at
    mu)}."""
    batch = dataset.preprocess(_hr_batch(dataset, np.array([item])))
    with torch.no_grad():
        feats, prior, _ = model.encode(batch["inputs"])
    mu = prior.mu[0].cpu().numpy()
    sigma = prior.sigma[0].cpu().numpy()
    top2 = np.argsort(sigma)[::-1][:2]

    a = np.linspace(-span, span, n)
    zs = np.repeat(mu[None], n * n, axis=0)
    g1, g2 = np.meshgrid(a, a, indexing="ij")
    zs[:, top2[0]] = mu[top2[0]] + g1.reshape(-1) * sigma[top2[0]]
    zs[:, top2[1]] = mu[top2[1]] + g2.reshape(-1) * sigma[top2[1]]

    decoded = decode_latent_grid(model, feats, zs)
    center = decode_latent_grid(model, feats, mu[None])[0]
    h, w, k = decoded.shape[1:]
    return {
        "dims": top2,
        "sigma": sigma,
        "grid_z": zs.reshape(n, n, -1),
        "decoded": decoded.reshape(n, n, h, w, k),
        "center": center,
    }
