"""Plain float32 Probabilistic U-Net: the reference of the training step and
of the prior ensemble.

The architecture is the one the configuration file states (Kohl et al.
2018, with the EDM/ADM U-Net backbone of the downscaling model: residual
blocks of GroupNorm, FiLM from the embedding, SiLU, dropout and 3x3
convolutions; prior and posterior axis-aligned Gaussians of three 3x3
convolutions a level; a three-layer 1x1 combination head). Parameters
live in a flat dict keyed by the measured program's parameter names, so
the seeded weights (``benchmark/weights.py``) land on both sides alike.

Everything is NCHW float32 PyTorch with TF32 off. The products and
convolutions take their operands through ``cast``: the identity for the
reference, a rounding to a lower precision for the control
(``benchmark/compare.py``). The combined decode and afCRPS terms are an
autograd function whose backward is the analytic sign-count gradient
(the same mathematics as autograd through ``abs``, and the same products
as the program's plain route, so the FLOP count of ``benchmark/counts``
matches the program's).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import masks

GN_EPS = 1e-5
SIGMA_EPS = 1e-7


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class ProbUNet:
    """The architecture of one configuration: ``spec`` lists every
    parameter (name, shape) in the program's order, ``dropout_blocks``
    the residual blocks in the order their seed words come."""

    def __init__(self, sizes: dict):
        self.s = s = sizes
        self.res = tuple(s["resolution"])
        self.mc = s["model_channels"]
        self.emb = self.mc * s["channel_mult_emb"]
        self.mult = tuple(s["channel_mult"])
        self.nb = s["num_blocks"]
        self.cin = s["input_channels"]
        self.k = s["num_classes"]
        self.d = s["latent_dim"]
        self.filters = tuple(s["num_filters"])
        self.c = self.filters[0]
        self.p_drop = float(s["dropout"])
        self.spec: list[tuple[str, tuple[int, ...]]] = []
        self.dropout_blocks: list[str] = []
        self.blocks: dict[str, dict] = {}
        self._build()

    # -- architecture ------------------------------------------------------
    def _add(self, name, shape):
        self.spec.append((name, tuple(shape)))

    def _block(self, name, cin, cout, up=False, down=False):
        p = f"unet.{name}"
        self._add(f"{p}.norm0.weight", (cin,))
        self._add(f"{p}.norm0.bias", (cin,))
        self._add(f"{p}.conv0.weight", (cout, cin, 3, 3))
        self._add(f"{p}.conv0.bias", (cout,))
        self._add(f"{p}.affine.weight", (2 * cout, self.emb))
        self._add(f"{p}.affine.bias", (2 * cout,))
        self._add(f"{p}.norm1.weight", (cout,))
        self._add(f"{p}.norm1.bias", (cout,))
        self._add(f"{p}.conv1.weight", (cout, cout, 3, 3))
        self._add(f"{p}.conv1.bias", (cout,))
        skip = "none"
        if cout != cin:
            skip = "conv"
            self._add(f"{p}.skip.weight", (cout, cin, 1, 1))
            self._add(f"{p}.skip.bias", (cout,))
        elif up or down:
            skip = "resample"
        self.blocks[name] = dict(cin=cin, cout=cout, up=up, down=down, skip=skip)
        self.dropout_blocks.append(name)

    def _build(self):
        mc, res = self.mc, self.res
        if self.s.get("label_dim", 1):
            self._add("unet.map_label.weight", (self.emb, self.s.get("label_dim", 1)))
        self.encoder, skips, cout = [], [], self.cin
        for level, mult in enumerate(self.mult):
            tag = f"{res[0] >> level}x{res[1] >> level}"
            if level == 0:
                name = f"enc_{tag}_conv"
                self._add(f"unet.{name}.weight", (mc * mult, self.cin, 3, 3))
                self._add(f"unet.{name}.bias", (mc * mult,))
                cout = mc * mult
            else:
                name = f"enc_{tag}_down"
                self._block(name, cout, cout, down=True)
            self.encoder.append(name)
            skips.append(cout)
            for i in range(self.nb):
                name = f"enc_{tag}_block{i}"
                self._block(name, cout, mc * mult)
                cout = mc * mult
                self.encoder.append(name)
                skips.append(cout)
        self.decoder = []
        for level, mult in reversed(list(enumerate(self.mult))):
            tag = f"{res[0] >> level}x{res[1] >> level}"
            if level == len(self.mult) - 1:
                for name in (f"dec_{tag}_in0", f"dec_{tag}_in1"):
                    self._block(name, cout, cout)
                    self.decoder.append((name, False))
            else:
                name = f"dec_{tag}_up"
                self._block(name, cout, cout, up=True)
                self.decoder.append((name, False))
            for i in range(self.nb + 1):
                name = f"dec_{tag}_block{i}"
                self._block(name, cout + skips.pop(), mc * mult)
                cout = mc * mult
                self.decoder.append((name, True))
        self._add("unet.out_norm.weight", (cout,))
        self._add("unet.out_norm.bias", (cout,))
        self._add("unet.out_conv.weight", (self.c, cout, 3, 3))
        self._add("unet.out_conv.bias", (self.c,))
        for enc, cin in (("prior", self.cin), ("posterior", self.cin + self.k)):
            for i, f in enumerate(self.filters):
                for j in range(3):
                    self._add(f"{enc}.enc{i}_conv{j}.weight", (f, cin, 3, 3))
                    self._add(f"{enc}.enc{i}_conv{j}.bias", (f,))
                    cin = f
            for head in ("conv_mu", "conv_log_sigma"):
                self._add(f"{enc}.{head}.weight", (self.d, cin, 1, 1))
                self._add(f"{enc}.{head}.bias", (self.d,))
        c, d, k = self.c, self.d, self.k
        for i, (cin, co) in enumerate(((c + d, c), (c, c), (c, k))):
            self._add(f"fcomb.layer{i}_weight", (cin, co))
            self._add(f"fcomb.layer{i}_bias", (co,))

    # -- layers --------------------------------------------------------------
    @staticmethod
    def _conv(P, name, x, cast, pad=1):
        w = P[f"{name}.weight"]
        return F.conv2d(cast(x), cast(w), padding=pad) + P[f"{name}.bias"][:, None, None]

    @staticmethod
    def _gn(P, name, x, silu, film=None, p=0.0, seed=None, b0=0, b_total=None):
        b, c, h, w = x.shape
        g = min(32, c // 4)
        xg = x.reshape(b, g, c // g, h, w)
        mean = xg.mean(dim=(2, 3, 4), keepdim=True)
        var = xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + GN_EPS)).reshape(b, c, h, w)
        y = y * P[f"{name}.weight"][:, None, None] + P[f"{name}.bias"][:, None, None]
        if film is not None:
            scale, shift = film
            y = y * (scale + 1.0)[:, :, None, None] + shift[:, :, None, None]
        if silu:
            y = F.silu(y)
        if p > 0.0:
            kp = masks.keep((b, h, w, c), seed, p, b0, b_total, g).permute(0, 3, 1, 2)
            y = torch.where(kp, y * torch.tensor(np.float32(1.0 / (1.0 - p)), device=y.device),
                            torch.zeros((), device=y.device))
        return y

    def _run_block(self, P, name, x, emb, skip_in, cast, train, seed, b0, b_total):
        spec, pre = self.blocks[name], f"unet.{name}"
        full = x if skip_in is None else torch.cat([x, skip_in], dim=1)
        h = self._gn(P, f"{pre}.norm0", full, silu=True)
        if spec["up"]:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        if spec["down"]:
            h = F.avg_pool2d(h, 2)
        h = self._conv(P, f"{pre}.conv0", h, cast)
        params = torch.matmul(cast(emb), cast(P[f"{pre}.affine.weight"]).T) + P[f"{pre}.affine.bias"]
        scale, shift = params.chunk(2, dim=-1)
        p = self.p_drop if train else 0.0
        h = self._gn(P, f"{pre}.norm1", h, silu=True, film=(scale, shift), p=p, seed=seed,
                     b0=b0, b_total=b_total)
        h = self._conv(P, f"{pre}.conv1", h, cast)
        if spec["skip"] == "conv":
            skip = self._conv(P, f"{pre}.skip", full, cast, pad=0)
        elif spec["skip"] == "resample":
            skip = (F.interpolate(full, scale_factor=2, mode="nearest") if spec["up"]
                    else F.avg_pool2d(full, 2))
        else:
            skip = full
        return h + skip

    def unet(self, P, x, cast=identity, train=False, seeds=None, b0=0, b_total=None):
        """x (B, H, W, C_in) -> features (B, H, W, C)."""
        b = x.shape[0]
        emb = torch.zeros((b, self.emb), device=x.device)
        if "unet.map_label.weight" in P:
            labels = torch.zeros((b, P["unet.map_label.weight"].shape[1]), device=x.device)
            emb = emb + torch.matmul(cast(labels), cast(P["unet.map_label.weight"]).T)
        emb = F.silu(emb)
        block_seed = dict(zip(self.dropout_blocks, seeds.unbind())) if train else {}
        kw = dict(cast=cast, train=train, b0=b0, b_total=b if b_total is None else b_total)
        h = x.permute(0, 3, 1, 2)
        skips = []
        for name in self.encoder:
            if name.endswith("_conv"):
                h = self._conv(P, f"unet.{name}", h, cast)
            else:
                h = self._run_block(P, name, h, emb, None, seed=block_seed.get(name), **kw)
            skips.append(h)
        for name, takes in self.decoder:
            h = self._run_block(P, name, h, emb, skips.pop() if takes else None,
                                seed=block_seed.get(name), **kw)
        h = self._gn(P, "unet.out_norm", h, silu=True)
        h = self._conv(P, "unet.out_conv", h, cast)
        return h.permute(0, 2, 3, 1)

    def gaussian(self, P, enc, x, target=None, cast=identity):
        """(mu, log_sigma), each (B, D)."""
        h = x if target is None else torch.cat([x, target], dim=-1)
        h = h.permute(0, 3, 1, 2)
        for i in range(len(self.filters)):
            if i:
                h = F.max_pool2d(h, 2)
            for j in range(3):
                h = torch.relu(self._conv(P, f"{enc}.enc{i}_conv{j}", h, cast))
        h = h.mean(dim=(2, 3), keepdim=True)
        return (self._conv(P, f"{enc}.conv_mu", h, cast, pad=0)[:, :, 0, 0],
                self._conv(P, f"{enc}.conv_log_sigma", h, cast, pad=0)[:, :, 0, 0])

    def ensemble(self, P, feats, zs, cast=identity):
        """feats (B, H, W, C), zs (M, B, D) -> (B, M, H, W, K)."""
        c = self.c
        w0 = P["fcomb.layer0_weight"]
        feat_part = torch.matmul(cast(feats), cast(w0[:c]))
        z_part = torch.matmul(cast(zs), cast(w0[c:])) + P["fcomb.layer0_bias"]
        h = torch.relu(feat_part[None] + z_part[:, :, None, None, :])
        h = torch.relu(torch.matmul(cast(h), cast(P["fcomb.layer1_weight"]))
                       + P["fcomb.layer1_bias"])
        out = torch.matmul(cast(h), cast(P["fcomb.layer2_weight"])) + P["fcomb.layer2_bias"]
        return out.transpose(0, 1)

    # -- the two paths ---------------------------------------------------------
    def sample(self, P, x, eps, cast=identity):
        """The prior ensemble (B, M, H, W, K) for the noise eps (M, B, D)."""
        feats = self.unet(P, x, cast)
        mu, log_sigma = self.gaussian(P, "prior", x, cast=cast)
        zs = mu + (torch.exp(log_sigma) + SIGMA_EPS) * eps
        return self.ensemble(P, feats, zs, cast)

    def elbo_items(self, P, x, target, eps, seeds, alpha, beta_0, beta_1, cast=identity,
                   b0=0, b_total=None):
        """Per item: beta_0 * afCRPS + beta_1 * KL(q || p) of the training
        ELBO (dropout on), its (recon, kl) parts, and the afCRPS's first
        term E|x - y| (the scale of the loss, which the afCRPS's difference
        of terms does not have)."""
        feats = self.unet(P, x, cast, train=True, seeds=seeds, b0=b0, b_total=b_total)
        mu_p, ls_p = self.gaussian(P, "prior", x, cast=cast)
        mu_q, ls_q = self.gaussian(P, "posterior", x, target, cast=cast)
        sq, sp = torch.exp(ls_q) + SIGMA_EPS, torch.exp(ls_p) + SIGMA_EPS
        ratio = (sq / sp) ** 2
        kl = 0.5 * torch.sum(ratio + ((mu_q - mu_p) / sp) ** 2 - 1.0 - torch.log(ratio), dim=-1)
        zs = mu_q + sq * eps                                            # (M, B, D)
        b, h, w, c = feats.shape
        m, k = zs.shape[0], target.shape[-1]
        w0 = P["fcomb.layer0_weight"]
        feat_t = torch.matmul(cast(w0[:c].T), cast(feats.reshape(b, h * w, c)).transpose(1, 2))
        z_t = (torch.matmul(cast(zs), cast(w0[c:])) + P["fcomb.layer0_bias"]).permute(1, 2, 0)
        target_t = target.reshape(b, h * w, k).transpose(1, 2).contiguous()
        t1, t2 = FcombCrpsTerms.apply(feat_t.contiguous(), z_t.contiguous(),
                                      P["fcomb.layer1_weight"], P["fcomb.layer1_bias"],
                                      P["fcomb.layer2_weight"], P["fcomb.layer2_bias"],
                                      target_t, cast)
        e = (1.0 - alpha) / m
        recon = (2.0 * (m - 1) * t1 - (1.0 - e) * 2.0 * t2) / (2.0 * m * (m - 1)) / (h * w * k)
        return beta_0 * recon + beta_1 * kl, recon, kl, t1 / (m * h * w * k)


def _pair_sum(ens: torch.Tensor) -> torch.Tensor:
    m = ens.shape[1]
    out = torch.zeros(ens.shape[0], device=ens.device)
    for d in range(1, m):
        out = out + torch.abs(ens[:, : m - d] - ens[:, d:]).sum(dim=(1, 2))
    return out


class FcombCrpsTerms(torch.autograd.Function):
    """(t1, t2) per item of the decoded ensemble: t1 = sum |x - y|, t2 =
    sum over member pairs |x_j - x_k|, straight from the layer-0
    projections feat_t (B, C, P) and z_t (B, C, M); backward by the
    sign counts, the hidden layers recomputed member by member."""

    @staticmethod
    def forward(ctx, feat_t, z_t, w1, b1, w2, b2, target_t, cast):
        b, c, p = feat_t.shape
        m = z_t.shape[2]
        h0 = torch.relu(feat_t[:, None] + z_t.permute(0, 2, 1)[..., None])    # (B, M, C, P)
        h1 = torch.relu(torch.matmul(cast(w1.T), cast(h0)) + b1[:, None])
        x = (torch.matmul(cast(w2.T), cast(h1)) + b2[:, None]).reshape(b, m, -1)
        tgt = target_t.reshape(b, -1)
        ctx.save_for_backward(feat_t, z_t, w1, b1, w2, b2, target_t)
        ctx.cast = cast
        return torch.abs(x - tgt[:, None, :]).sum(dim=(1, 2)), _pair_sum(x)

    @staticmethod
    def backward(ctx, g1, g2):
        feat_t, z_t, w1, b1, w2, b2, target_t = ctx.saved_tensors
        cast = ctx.cast
        m = z_t.shape[2]
        w1r, w2r = cast(w1), cast(w2)

        def hidden(j):
            h0 = torch.relu(feat_t + z_t[:, :, j:j + 1])
            return h0, torch.relu(torch.matmul(w1r.T, cast(h0)) + b1[:, None])

        x = torch.stack([torch.matmul(w2r.T, cast(hidden(j)[1])) + b2[:, None]
                         for j in range(m)], dim=1)                        # (B, M, K, P)
        s0 = torch.sign(x - target_t[:, None])
        count = torch.zeros_like(s0)
        for d in range(1, m):
            s = torch.sign(x[:, : m - d] - x[:, d:])
            count[:, : m - d] += s
            count[:, d:] -= s
        dx_all = g1[:, None, None, None] * s0 + g2[:, None, None, None] * count
        del x, count
        dfeat, dz = torch.zeros_like(feat_t), torch.zeros_like(z_t)
        dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
        dw2, db2 = torch.zeros_like(w2), torch.zeros_like(b2)
        for j in range(m):
            dx = dx_all[:, j]
            h0, h1 = hidden(j)
            dw2 += torch.matmul(cast(h1), cast(dx).transpose(1, 2)).sum(dim=0)
            db2 += dx.sum(dim=(0, 2))
            da1 = torch.matmul(w2r, cast(dx)) * (h1 > 0)
            dw1 += torch.matmul(cast(h0), cast(da1).transpose(1, 2)).sum(dim=0)
            db1 += da1.sum(dim=(0, 2))
            du = torch.matmul(w1r, cast(da1)) * (h0 > 0)
            dfeat += du
            dz[:, :, j] = du.sum(dim=2)
        return dfeat, dz, dw1, db1, dw2, db2, None, None


class AdamW:
    """Decoupled-decay Adam on a flat dict of leaves (bias corrections in
    float32, every leaf decayed, no clipping)."""

    def __init__(self, P: dict, lr: float, weight_decay: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in P.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in P.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> None:
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for k, p in P.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps) + self.wd * p
            p.add_(upd, alpha=-self.lr)
