"""The comparison that decides ``correct``: the plain reference run on the
inputs the program was given, and the numbers held against the limits of
the cell's workload file.

Training: the reference takes the program's first steps from the same
seeded weights, batches (re-gathered from the raw fields), noise and seed
words, in blocks of ``reference_chunk`` items (the ELBO is a mean over
items, so the blocks' gradients add up to the batch's). Three numbers:

- ``loss_gap``: the largest |loss - reference loss| over the check
  steps, each over the scale of the reference's loss: beta_0 E|x - y| +
  beta_1 KL, the size of its positive terms (the afCRPS is a difference
  of two terms that can nearly cancel, so its own value is no scale);
- ``grad_gap``: the first gradient, leaf by leaf, as the optimizer holds
  it after one step (its first moment / (1 - b1)): the largest gap
  between the two norms over max(the reference leaf's norm, the median
  leaf's);
- ``change_gap``: the same of each leaf's change after the check steps;
- ``kl_gap``: the largest |KL - reference KL| / reference KL over the
  check steps (the KL of the posterior to the prior, batch mean).

Leaves whose reference gradient is under a thousandth of the median
leaf's are not counted (their change is decay and round-off), nor leaves
of one element: such a leaf (the bias of a one-class head) sums the signed
afCRPS terms of every pixel and member, and its gradient is round-off
noise in any precision.

Evaluation: the reference recomputes a sample of the window's batches
(drawn from the seed) from the raw fields and the same noise, and the
per-item, per-variable CRPS, MAE of the ensemble mean and spread are held
to it: ``crps_gap``, ``mae_gap``, ``spread_gap``, each the largest
|program - reference| / max(|reference|, the median |reference| of that
metric and variable). A missing or extra row reads infinite.

The control of the limits (``benchmark/calibrate.py``), in both modes:
the reference with every convolution's and product's operands rounded to
fp8 (e4m3 forward, e5m2 gradients, one scale a tensor) in the program's
place.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import data as rdata
from benchmark.reference.model import AdamW, ProbUNet, identity

GRAD_FLOOR = 1e-3   # leaves counted: reference gradient >= this x the median leaf's


def _fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to an fp8 type with one scale (its absmax over the
    type's largest value)."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).float() * s


class _Fp8(torch.autograd.Function):
    """An operand rounded to fp8 e4m3 going forward, and the gradient that
    reaches it rounded to fp8 e5m2 going back: the usual fp8 training
    recipe, so the products of both passes take fp8 operands."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """The control's rounding of an operand (see :class:`_Fp8`)."""
    return _Fp8.apply(t) if t.requires_grad else _fp8_round(t)


@contextlib.contextmanager
def _f32():
    """TF32 off for the reference's products and convolutions."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def reference_train(cell, seed: int, raw: np.ndarray, check_idx, noise, device,
                    cast=identity, items: int | None = None, update: bool = True) -> dict:
    """The reference's readings of the check steps: losses, the first
    gradient's and the change's norm per leaf. A fault's readings:
    ``items``, only the first ``items`` of each batch, the mean over them;
    ``update=False``, a step that leaves the parameters as they were."""
    with _f32():
        return _reference_train(cell, seed, raw, check_idx, noise, device, cast, items, update)


def _reference_train(cell, seed, raw, check_idx, noise, device, cast, items, update) -> dict:
    s, tp = harness.sizes(cell), cell.params
    net = ProbUNet(s)
    P = {k: v.clone().requires_grad_() for k, v in weights.seeded(net.spec, seed, device).items()}
    p0 = {k: v.detach().clone() for k, v in P.items()}
    opt = AdamW(P, s["lr"], s["weight_decay"])
    stats = rdata.split_stats(raw, s["variables"], s["lowres_scale"], device)
    chunk = tp["reference_chunk"]
    losses, scales, recons, kls, grad = [], [], [], [], None
    for k, (idx, (eps, seeds)) in enumerate(zip(check_idx, noise)):
        b_total = len(idx)
        n = b_total if items is None else items
        grads = {key: torch.zeros_like(v) for key, v in P.items()}
        loss = err = recon = kl = 0.0
        for a in range(0, n, chunk):
            c = min(chunk, n - a)
            raw_b = torch.from_numpy(raw[idx[a:a + c]]).to(device)
            batch = rdata.preprocess(raw_b, stats, s["variables"], s["lowres_scale"], s["epsilon"])
            total, rec, kli, eri = net.elbo_items(P, batch["inputs"], batch["targets"],
                                         eps[:, a:a + c].to(device), seeds.to(device), s["alpha"],
                                         tp["beta_0"], tp["beta_1"], cast, b0=a, b_total=b_total)
            part = total.sum() / n
            gs = torch.autograd.grad(part, list(P.values()), allow_unused=True)
            for key, g in zip(P, gs):
                if g is not None:
                    grads[key] += g
            loss += float(part.detach())
            recon += float(rec.detach().sum()) / n
            kl += float(kli.detach().sum()) / n
            err += float(eri.detach().sum()) / n
            del total, part, gs, batch, raw_b, rec, kli, eri
        if update:
            opt.step(P, grads)
        losses.append(loss)
        recons.append(recon)
        kls.append(kl)
        scales.append(tp["beta_0"] * err + tp["beta_1"] * kl)
        if k == 0:
            grad = {key: float(torch.linalg.vector_norm(g)) for key, g in grads.items()}
        del grads
    change = {key: float(torch.linalg.vector_norm(P[key].detach() - p0[key])) for key in P}
    return {"loss": losses, "recon": recons, "kl": kls, "scale": scales, "grad": grad,
            "change": change, "size": {key: v.numel() for key, v in P.items()}}


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    ref = np.array([want[k] for k in leaves])
    med = float(np.median(ref))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in leaves)


def train_numbers(got: dict, want: dict) -> dict:
    """The three numbers of readings ``got`` against the reference's."""
    med = float(np.median(list(want["grad"].values())))
    leaves = [k for k, v in want["grad"].items()
              if v >= GRAD_FLOOR * med and want["size"][k] > 1]
    loss = max(abs(a - b) / s for a, b, s in zip(got["loss"], want["loss"], want["scale"]))
    kl = max(abs(a - b) / b for a, b in zip(got["kl"], want["kl"]))
    return {"loss_gap": loss, "kl_gap": kl,
            "grad_gap": _leaf_gap(got["grad"], want["grad"], leaves),
            "change_gap": _leaf_gap(got["change"], want["change"], leaves)}


def _checks(numbers: dict, limits: dict) -> list:
    """(name, value, limit) of each number the cell holds to a limit."""
    return [(k, float(numbers[k]) if math.isfinite(numbers[k]) else float("inf"), lim)
            for k, lim in limits.items()]


def train_checks(cell, run, raw, check_idx, noise, program: dict) -> tuple[list, dict]:
    """(checks, the reference's readings)."""
    ref = reference_train(cell, run.seed, raw, check_idx, noise, run.device)
    return _checks(train_numbers(program, ref), cell.limits), ref


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def batch_noise(seed: int, i: int, members: int, batch: int, latent: int, device):
    """The latent noise (members, batch, latent) of the window's batch ``i``."""
    g = torch.Generator(device=device).manual_seed(weights.mix(seed, 1000 + i))
    return torch.randn((members, batch, latent), generator=g, device=device)


@torch.no_grad()
def reference_eval(cell, seed: int, raw: np.ndarray, batches, device,
                   cast=identity) -> list[dict]:
    """The reference's per-item (B, C) CRPS, MAE and spread of each
    (window index, day indices) in ``batches``, as numpy arrays; with
    ``cast=fp8``, the control's."""
    with _f32():
        return _reference_eval(cell, seed, raw, batches, device, cast)


def _reference_eval(cell, seed, raw, batches, device, cast) -> list[dict]:
    s, tp = harness.sizes(cell), cell.params
    net = ProbUNet(s)
    P = weights.seeded(net.spec, seed, device)
    stats = rdata.split_stats(raw, s["variables"], s["lowres_scale"], device)
    out = []
    for i, idx in batches:
        raw_b = torch.from_numpy(raw[idx]).to(device)
        batch = rdata.preprocess(raw_b, stats, s["variables"], s["lowres_scale"], s["epsilon"])
        eps = batch_noise(seed, i, tp["members"], len(idx), s["latent_dim"], device)
        res = net.sample(P, batch["inputs"], eps, cast)
        ens = rdata.to_physical(rdata.to_hr(res, batch["lrinterp"], stats, s["epsilon"]),
                                s["variables"])
        gt = rdata.to_physical(batch["hr"], s["variables"])
        out.append({k: v.cpu().numpy() for k, v in rdata.eval_items(ens, gt).items()})
        del res, ens, gt, batch, raw_b
    return out


def eval_numbers(got: list[dict], want: list[dict]) -> dict:
    """Of the program's rows ``got`` against the reference's, batch by
    batch, per metric: ``<metric>_gap``, the widest gap of an item and
    variable, and ``<metric>_mean_gap``, the mean gap over them."""
    out = {}
    for key in ("crps", "mae", "spread"):
        if len(got) != len(want) or any(g[key].shape != w[key].shape for g, w in zip(got, want)):
            out[f"{key}_gap"] = out[f"{key}_mean_gap"] = float("inf")
            continue
        g = np.concatenate([r[key] for r in got]).astype(np.float64)
        w = np.concatenate([r[key] for r in want]).astype(np.float64)
        floor = np.median(np.abs(w), axis=0, keepdims=True)
        gap = np.abs(g - w) / np.maximum(np.abs(w), floor)
        ok = bool(np.all(np.isfinite(gap)))
        out[f"{key}_gap"] = float(gap.max()) if ok else float("inf")
        out[f"{key}_mean_gap"] = float(gap.mean()) if ok else float("inf")
    return out


def eval_checks(cell, run, raw, batches, rows: list[dict]) -> tuple[list, list]:
    """(checks, the reference's rows)."""
    ref = reference_eval(cell, run.seed, raw, batches, run.device)
    return _checks(eval_numbers(rows, ref), cell.limits), ref
