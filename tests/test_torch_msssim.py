"""The WMSE + MS-SSIM and L1 losses, port against JAX, on seeded numpy
fields at 128x128 (MS-SSIM at win_size 7 needs sides above 96).

f32: rtol 1e-5 / atol 1e-6 (the same filters and sums in another order).
bf16 inputs: rtol 2e-2 / atol 2e-3, and the bf16 gradient within 2e-2 of
the JAX one in norm (||g - g_jax|| / ||g_jax||). The window, the filtered maps and
their products are bf16 in both packages, but XLA on the CPU may keep a
bf16 chain's intermediates in f32 where torch rounds every operation
(2^-8 relative per rounding, a few roundings deep).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.ops import losses as tl
from probunet_tpu_torch.ops import msssim as tm

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-3)}


def _fields(seed, shape=(2, 128, 128, 3)):
    """A smooth field and a noisy copy of it, so SSIM sits well inside (0, 1)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (1, 2):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), ax, base)
    noisy = base + 0.3 * rng.standard_normal(shape).astype(np.float32)
    return base.astype(np.float32), noisy.astype(np.float32)


def _both(a, dtype):
    return (jnp.asarray(a, dtype=getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssim_and_ms_ssim_match_jax(dtype):
    from probunet_tpu.ops import msssim as jm

    x, y = _fields(0)
    jx, tx = _both(x, dtype)
    jy, ty = _both(y, dtype)
    rtol, atol = TOL[dtype]
    for size_average in (True, False):
        want = jm.ssim(jx, jy, data_range=4.0, size_average=size_average)
        got = tm.ssim(tx, ty, data_range=4.0, size_average=size_average)
        assert got.dtype == tx.dtype
        assert_close(got.float(), np.asarray(want, np.float32), rtol, atol, "ssim")
        want = jm.ms_ssim(jx, jy, data_range=4.0, win_size=7, size_average=size_average)
        got = tm.ms_ssim(tx, ty, data_range=4.0, win_size=7, size_average=size_average)
        assert_close(got.float(), np.asarray(want, np.float32), rtol, atol, "ms_ssim")
    # a tensor data range promotes a bf16 map to f32, as a JAX array does
    want = jm.ms_ssim(jx, jnp.asarray(y), data_range=jnp.float32(4.0), win_size=7)
    got = tm.ms_ssim(tx, torch.from_numpy(y), data_range=torch.tensor(4.0), win_size=7)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_close(got, want, rtol, atol, "ms_ssim, mixed dtypes")


def test_ms_ssim_side_limit_and_zero_cs():
    """Sides of 96 and below raise at win_size 7; a level whose cs is
    negative gives 0 through the relu, with finite gradients."""
    x = torch.zeros((1, 96, 128, 1))
    with pytest.raises(ValueError, match="too small"):
        tm.ms_ssim(x, x, data_range=1.0, win_size=7)
    a, b = _fields(1, (1, 128, 128, 1))
    xa = torch.from_numpy(a).requires_grad_()
    val = tm.ms_ssim(xa, torch.from_numpy(-a), data_range=1.0, win_size=7)
    val.backward()
    assert float(val.detach()) == 0.0 and torch.isfinite(xa.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lam", [0.0, 0.3])
def test_wmse_ms_ssim_loss_matches_jax(dtype, lam):
    """Value, both components and the gradient w.r.t. the prediction; a
    5-D ensemble collapses to its mean; the data range is the target's."""
    import jax

    from probunet_tpu.ops import losses as jl

    target, _ = _fields(2)
    ens = np.stack([_fields(3 + i)[1] for i in range(3)], axis=1)     # (B, 3, H, W, C)
    rtol, atol = TOL[dtype]
    for pred in (ens[:, 0], ens):
        jp, tp = _both(pred, dtype)
        tp.requires_grad_()
        kw = dict(alpha=0.007, beta=0.048, lam=lam)

        def jloss(p):
            c, w, m = jl.wmse_ms_ssim_loss(p, jnp.asarray(target), return_components=True,
                                           **kw)
            return c, (w, m)

        (want, (ww, wm)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
        got, gw, gm = tl.wmse_ms_ssim_loss(tp, torch.from_numpy(target),
                                           return_components=True, **kw)
        got.backward()
        assert_close(got.detach(), want, rtol, atol, "loss")
        assert_close(gw.detach(), ww, rtol, atol, "wmse")
        assert_close(gm.detach(), wm, rtol, atol, "msssim")
        jg = np.asarray(jg, np.float32)
        if dtype == "float32":
            assert_close(tp.grad, jg, rtol, atol * float(np.abs(jg).max()), "grad")
        else:  # a bf16 gradient: its norm-relative error
            err = np.linalg.norm(tp.grad.float().numpy() - jg) / np.linalg.norm(jg)
            assert err <= rtol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_losses_and_weights_match_jax(dtype):
    from probunet_tpu.ops import losses as jl

    pred, target = _fields(4)
    jp, tp = _both(pred, dtype)
    jt, tt = _both(target, dtype)
    rtol, atol = TOL[dtype]
    assert_close(tl.l1_loss(tp, tt).float(), np.asarray(jl.l1_loss(jp, jt), np.float32),
                 rtol, atol, "l1")
    got = tl.l1_loss_per_channel(tp, tt)
    assert got.shape == (3,)
    assert_close(got.float(), np.asarray(jl.l1_loss_per_channel(jp, jt), np.float32),
                 rtol, atol, "l1 per channel")
    y = np.linspace(-80, 120, 401, dtype=np.float32)
    assert_close(tl.wmse_weights(torch.from_numpy(y)), jl.wmse_weights(jnp.asarray(y)),
                 1e-6, 0.0, "weights")


def test_pairwise_oracles_match_jax_and_the_sorted_losses():
    from probunet_tpu.ops import losses as jl

    rng = np.random.default_rng(5)
    ens = rng.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    tgt = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    te, tt = torch.from_numpy(ens), torch.from_numpy(tgt)
    for ours, theirs, fast in (
            (tl.afcrps_loss_pairwise(te, tt, 0.9), jl.afcrps_loss_pairwise(ens, tgt, 0.9),
             tl.afcrps_loss(te, tt, 0.9)),
            (tl.crps_loss_pairwise(te, tt), jl.crps_loss_pairwise(ens, tgt),
             tl.crps_loss(te, tt))):
        assert_close(ours, theirs, 1e-5, 1e-7, "oracle")
        assert_close(fast, ours, 1e-5, 1e-7, "loss vs oracle")


def test_weight_function_analysis_matches_jax():
    from probunet_tpu.evals.weights import weight_function_analysis as jwfa

    from probunet_tpu_torch.evals import weight_function_analysis

    t = 40.0 * np.random.default_rng(6).standard_normal((4, 8, 8, 2)).astype(np.float32)
    got, want = weight_function_analysis(t, bins=20), jwfa(t, bins=20)
    assert list(got) == list(want) == ["pr", "tasmin"]
    for var in want:
        for key, val in want[var].items():
            if key == "target_counts":
                assert np.array_equal(got[var][key], val)
            else:
                assert_close(got[var][key], val, 1e-6, 1e-9, f"{var} {key}")
