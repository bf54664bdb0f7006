"""Shared inputs and references of the spatially sharded step's tests
(``tests/test_torch_parallel_spatial_*.py``): the tiny model at 32x32
(4x pooling, two levels, so a block of 16 or 8 rows divides by the pooling
factor and the pools; 128x128 for the MS-SSIM ELBO), its one-process
steps in the port, and the JAX package's one-device train step on the
same posterior noise. A case's or a call's ``loss`` sets ``cfg.loss``
fields (the ELBO and its weights).
"""

from __future__ import annotations

import numpy as np
import torch

from torch_mp import tiny_cfg
from torch_parity import assert_close, jax_tiny_model, torch_tiny_model

RES = 32
B, M = 8, 3
DROPOUT = 0.1
RESOLUTION = (RES, RES)


def hr_fields(seed: int, n: int = B, res: int = RES) -> np.ndarray:
    """n synthetic ClimEx days at res x res in storage space."""
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
    from probunet_tpu_torch.data.transforms import apply_physical_transform

    phys = synthetic_climex_fields(n, res, res, seed=seed)
    return apply_physical_transform(torch.from_numpy(phys), ("pr", "tasmin", "tasmax")).numpy()


def params(num_filters: tuple[int, ...] = (8, 16)) -> dict:
    """The tiny model's noisy parameters at RES x RES (numpy, Flax tree);
    ``num_filters`` (32, 16) gives Fcomb the width kernel A takes."""
    return jax_tiny_model(num_filters=num_filters, img_resolution=RESOLUTION)[1]


def port_cfg(batch: int, m: int, resolution=RESOLUTION, loss: dict | None = None, **data):
    """``tiny_cfg`` at ``resolution`` with the ``loss`` fields set."""
    cfg = tiny_cfg(batch, m, resolution=tuple(resolution), **data)
    for k, v in (loss or {}).items():
        setattr(cfg.loss, k, v)
    return cfg


def jax_cfg(batch: int, m: int, resolution=RESOLUTION, loss: dict | None = None, **data):
    """The JAX package's config of :func:`port_cfg`."""
    from probunet_tpu.config import Config

    cfg = Config()
    t = port_cfg(batch, m, resolution, loss, **data)
    for sec in ("data", "model", "train", "loss"):
        for k, v in vars(getattr(t, sec)).items():
            setattr(getattr(cfg, sec), k, v)
    return cfg


def jax_train_step(monkeypatch, hr: np.ndarray, eps: np.ndarray, loss: dict | None = None):
    """(metrics, the port's state dict of the parameters) after one JAX
    ``make_train_step`` on one device at hr's resolution, dropout 0, the
    posterior noise ``eps`` ((M, B, D), or (B, D) for the L1 ELBO),
    beta_1 = 0.1."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import compute_stats
    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.train.loop import make_train_step
    from probunet_tpu.train.state import TrainState, make_optimizer
    from probunet_tpu_torch.convert import convert_params

    res = tuple(hr.shape[1:3])
    jmodel, p = jax_tiny_model(img_resolution=res)
    e = jnp.asarray(eps)
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * e)
    state = TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, p),
                              tx=make_optimizer(), rng=jax.random.key(0))
    step = make_train_step(jmodel, jax_cfg(hr.shape[0], eps.shape[0], res, loss),
                           donate=False)
    new, met = step(state, jnp.asarray(hr), compute_stats(jnp.asarray(hr), 4),
                    jnp.float32(1.0), jnp.float32(0.1))
    want = convert_params(jax.device_get(new.params), torch_tiny_model(p, img_resolution=res))
    return {k: float(v) for k, v in met.items()}, want


def one_process(case: dict, steps: int | None = None, states: list | None = None):
    """The port's one-process train step (or eval step) on the whole batch
    of a spawned case: (metrics of each step, gradients AdamW received at
    each step, state dict). ``states``: a list that gets the train state
    before each step (``torch_mp_worker.train_state_of``)."""
    from torch_mp_worker import captured_grads, train_state_of

    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.train.loop import make_eval_step, make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    hr = torch.from_numpy(case["hr"])
    res = tuple(hr.shape[1:3])
    cfg = port_cfg(hr.shape[0], case["m"], res, case.get("loss"), **case.get("data", {}))
    nf = case.get("num_filters", (8, 16))
    model = torch_tiny_model(case["params"] if "params" in case else params(nf),
                             dropout=case["dropout"],
                             gn_impl=case["gn_impl"], remat=case.get("remat", False),
                             num_filters=nf, img_resolution=res,
                             act_compress=case.get("act_compress", False))
    stats = compute_stats(hr, cfg.data.lowres_scale)
    if case.get("eval"):
        met = make_eval_step(model, cfg, fused=case["fused"])(
            hr, stats, torch.Generator().manual_seed(3))
        return [met], [], None
    state = create_train_state(model, seed=cfg.train.seed, device="cpu")
    grads = captured_grads(state)
    step = make_train_step(model, cfg, fused=case["fused"])
    eps = None if case["eps"] is None else torch.from_numpy(case["eps"])
    metrics = []
    for _ in range(steps or case["steps"]):
        if states is not None:
            states.append(train_state_of(state))
        state, met = step(state, hr, stats, 1.0, 0.1, eps=eps)
        metrics.append(met)
    return metrics, grads, model.state_dict()


def assert_ranks_agree(outs) -> None:
    """Every rank returns the same values (a replicated result)."""
    first, *rest = outs

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    for other in rest:
        for x, y in zip(leaves(first), leaves(other)):
            torch.testing.assert_close(torch.as_tensor(x), torch.as_tensor(y), rtol=0, atol=0)


def assert_grads_close(got: list, want: list, rtol: float, what: str) -> float:
    """The largest difference of two gradient lists over the largest
    gradient, at most ``rtol``; returns it."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    err /= max(float(b.abs().max()) for b in want)
    assert err <= rtol, f"{what}: gradients {err:.3e} apart (limit {rtol})"
    return err


def assert_metrics_close(got: dict, want: dict, rtol: float, what: str,
                         names=("loss", "recon", "kl_mean", "grad_norm")) -> None:
    for k in names:
        if k in want:
            assert_close(got[k], want[k], rtol, 0.0, f"{what} {k}")
