"""The port's int8 saved convolution inputs (``probunet_tpu_torch/ops/
act_compress.py``, kernels F and F′ through their plain versions on the
CPU) against the JAX package's ``probunet_tpu/ops/act_compress.py``, with
the same numpy-seeded inputs.

Tolerances:
- q, s and xh: bit for bit (the same f32 division, ties to even, one f32
  product), f32 and bf16 inputs, ties and an all-zero channel included;
- the forward and dx against the port's own float convolution: bit for
  bit (dx never reads the stored input); dW against the float weight
  gradient at the dequantized input: bit for bit;
- dx and dW against JAX's ``act8_conv`` (the JAX test's input scale): dx
  rtol / atol 1e-5; dW rtol 1e-5, JAX's own bound
  (``tests/test_act_compress.py:55-57``), and atol 1e-6 of the largest
  |dW|. JAX's atol 1e-5 holds one library against itself; the two
  libraries' float convolutions sum 512 products in other orders, and
  their float dW already differ by up to 5.3e-5 where |dW| reaches 75
  (7e-7 of it; the compressed dW by 4.6e-5);
- the training ELBO (32x32, the small config of
  ``tests/test_act_compress.py:73-95``, dropout on, composed GroupNorm
  route) against the JAX package under ``PROBUNET_ACT_COMPRESS=int8``: the
  loss and every gradient rtol 1e-4 / atol 1e-5 leaf by leaf, the float
  ELBO's bound (``test_torch_train.py``);
- the remat modes and the eval step: bit for bit against no remat and the
  float model.
"""

import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close, jax_elbo_grads, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.ops import act_compress as tac

pytestmark = pytest.mark.usefixtures("torch_one_thread")

JAX_RTOL = JAX_ATOL = 1e-5
DW_ATOL_SHARE = 1e-6
ELBO_RTOL, ELBO_ATOL = 1e-4, 1e-5
RES, B, M, DROPOUT = (32, 32), 4, 3, 0.1
QUANT_SHAPES = [(2, 16, 16, 8), (3, 8, 8, 6), (2, 4, 4, 32)]


def _quant_input(shape, dtype):
    """Per-channel scales over four decades, an all-zero channel and a
    channel of exact ties: absmax 127 / 8, so s = 1/8 and every element
    (k + 1/2) / 8 lies halfway between two integers of x / s."""
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) * np.logspace(-2, 2, shape[-1])
    x[..., 0] = 0.0
    ties = (rng.integers(-127, 127, shape[:-1]) + 0.5) / 8
    ties.flat[0] = 127 / 8
    x[..., 1] = ties
    xj = jnp.asarray(x, dtype=dtype)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=str)
def test_quantize_and_dequantize_match_jax_bit_for_bit(shape, dtype):
    import jax.numpy as jnp

    from probunet_tpu.ops.act_compress import _quantize_channels

    xj, xt = _quant_input(shape, dtype)
    qj, sj = _quantize_channels(xj)
    q, s = tac.quantize_channels(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(qj))
    assert np.array_equal(s.numpy(), np.asarray(sj))
    assert float(s[1]) == 1 / 8 and (q[..., 1].flatten()[1:] % 2 == 0).all()  # ties to even
    xh = tac.dequantize(q, s, xt.dtype)
    want = (qj.astype(jnp.float32) * sj).astype(xj.dtype)
    assert xh.dtype == xt.dtype
    assert np.array_equal(xh.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _conv_case(k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = (rng.standard_normal((k, k, 8, 16)) * 0.1).astype(np.float32)     # HWIO
    g = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    return x, w, g


def _nchw(a):
    """NHWC numpy -> the NCHW channels_last view the port's layers hold."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _grads(fn, x, w, g):
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(x, w)
    return (y.detach(), *torch.autograd.grad(y, (x, w), g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,padded", [(3, False), (1, False), (3, True)])
def test_act8_conv_forward_and_dx_exact_dw_at_the_dequantized_input(k, padded, dtype):
    """Against the port's float convolution: ``padded`` is the halo-padded
    block of a spatial mesh (VALID over the rows)."""
    x, w, g = _conv_case(k, 7 + k)
    dt = getattr(torch, dtype)
    xt = _nchw(x).to(dt)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)                          # OIHW
    gt = _nchw(g[:, 2 * (k // 2):] if padded else g).to(dt)   # VALID rows when padded
    y, dx, dw = _grads(lambda a, b: tac.act8_conv(a, b, dt, padded), xt, wt, gt)
    y0, dx0, _ = _grads(lambda a, b: tac.conv(a, b, dt, padded), xt, wt, gt)
    assert torch.equal(y, y0) and torch.equal(dx, dx0)
    assert dx.dtype == dt and dw.dtype == torch.float32
    q, s = tac.quantize_channels(xt.permute(0, 2, 3, 1).contiguous())
    xh = tac.dequantize(q, s, dt).permute(0, 3, 1, 2)
    _, _, dw_xh = _grads(lambda a, b: tac.conv(a, b, dt, padded), xh, wt, gt)
    assert torch.equal(dw, dw_xh)
    assert not torch.equal(dw, _grads(lambda a, b: tac.conv(a, b, dt, padded), xt, wt, gt)[2])


@pytest.mark.parametrize("k", [3, 1])
def test_act8_conv_gradients_match_jax(k):
    import jax
    import jax.numpy as jnp

    from probunet_tpu.ops.act_compress import act8_conv

    x, w, g = _conv_case(k, 17 + k)
    jdx, jdw = jax.grad(lambda a, b: jnp.vdot(act8_conv(a, b, k // 2, jnp.float32), g),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _, dx, dw = _grads(lambda a, b: tac.act8_conv(a, b, torch.float32), _nchw(x),
                       torch.from_numpy(w).permute(3, 2, 0, 1), _nchw(g))
    assert_close(dx.permute(0, 2, 3, 1), np.asarray(jdx), JAX_RTOL, JAX_ATOL, "dx")
    jdw = np.asarray(jdw)
    assert_close(dw.permute(2, 3, 1, 0), jdw, JAX_RTOL, DW_ATOL_SHARE * np.abs(jdw).max(), "dW")


def test_split_conv_quantizes_each_input(monkeypatch):
    """``EDMConv(x, x2)`` with compression: two quantizations, each of its
    own input, the forward and both dx exact, dW the float one at both
    dequantized inputs."""
    from probunet_tpu_torch.models.layers import EDMConv

    rng = np.random.default_rng(3)
    x, x2 = (_nchw(rng.standard_normal((2, 8, 8, c)).astype(np.float32)) for c in (8, 16))
    g = _nchw(rng.standard_normal((2, 8, 8, 12)).astype(np.float32))
    conv = EDMConv(24, 12, 1, generator=torch.Generator().manual_seed(0))
    calls = []
    real = tac.quantize_channels
    monkeypatch.setattr(tac, "quantize_channels",
                        lambda xn, mesh=None: calls.append(xn.shape[-1]) or real(xn, mesh))

    def run(a, b, on):
        conv.act_compress = on
        a, b = a.detach().requires_grad_(), b.detach().requires_grad_()
        y = conv(a, b)
        return (y.detach(), *torch.autograd.grad(y, (a, b, conv.weight), g))

    y, dx, dx2, dw = run(x, x2, True)
    assert calls == [8, 16]
    y0, dx0, dx20, _ = run(x, x2, False)
    assert torch.equal(y, y0) and torch.equal(dx, dx0) and torch.equal(dx2, dx20)
    xh, xh2 = (real(a.permute(0, 2, 3, 1).contiguous()) for a in (x, x2))
    xh, xh2 = (tac.dequantize(q, s, torch.float32).permute(0, 3, 1, 2) for q, s in (xh, xh2))
    assert torch.equal(dw, run(xh, xh2, False)[3])


@pytest.fixture(scope="module")
def models():
    jmodel, params = jax_tiny_model(dropout=DROPOUT, img_resolution=RES)
    return jmodel, params


def _batch():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, *RES, TINY["input_channels"])).astype(np.float32)
    y = rng.standard_normal((B, *RES, TINY["num_classes"])).astype(np.float32)
    eps = rng.standard_normal((M, B, TINY["latent_dim"])).astype(np.float32)
    return x, y, eps


def _port_elbo(params, x, y, eps, seeds, act_compress=True, remat=False):
    model = torch_tiny_model(params, dropout=DROPOUT, gn_impl="composed", remat=remat,
                             img_resolution=RES, act_compress=act_compress)
    total, met = model.elbo(torch.from_numpy(x), torch.from_numpy(y), M=M, beta_1=0.7,
                            eps=torch.from_numpy(eps), training=True,
                            seeds=torch.from_numpy(seeds))
    total.backward()
    return model, total.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_training_elbo_matches_jax_under_act_compress(models, monkeypatch):
    """The training ELBO's loss and every gradient against the JAX model's
    under PROBUNET_ACT_COMPRESS=int8; the loss equals the port's float
    ELBO's, and the weight gradients differ from the float ones."""
    from probunet_tpu_torch.convert import convert_params

    jmodel, params = models
    x, y, eps = _batch()
    monkeypatch.setenv("PROBUNET_ACT_COMPRESS", "int8")
    want_total, _, want_grads, seeds = jax_elbo_grads(
        monkeypatch, jmodel, params, x, y, eps, "afcrps", True, 0.7, M, "composed")
    model, total, grads = _port_elbo(params, x, y, eps, seeds)
    assert_close(total, want_total, ELBO_RTOL, ELBO_ATOL, "loss")
    want = convert_params(want_grads, model)
    for name, grad in grads.items():
        assert grad is not None, name
        assert_close(grad, want[name], ELBO_RTOL, ELBO_ATOL, f"d{name}")
    _, total0, grads0 = _port_elbo(params, x, y, eps, seeds, act_compress=False)
    assert torch.equal(total, total0)
    assert not torch.equal(grads["unet.enc_32x32_block0.conv0.weight"],
                           grads0["unet.enc_32x32_block0.conv0.weight"])


@pytest.mark.parametrize("remat", [True, "save_convs"], ids=str)
def test_remat_leaves_the_compressed_gradients_unchanged(models, remat):
    """A recompute quantizes the same input again: the loss and every
    gradient bit for bit as without remat."""
    _, params = models
    x, y, eps = _batch()
    n = len(torch_tiny_model(params, dropout=DROPOUT, img_resolution=RES).unet.dropout_blocks)
    seeds = np.arange(2 * n, dtype=np.int32).reshape(n, 2) * 7919
    _, total0, grads0 = _port_elbo(params, x, y, eps, seeds)
    _, total, grads = _port_elbo(params, x, y, eps, seeds, remat=remat)
    assert torch.equal(total, total0)
    for name, grad in grads.items():
        assert torch.equal(grad, grads0[name]), name


def test_eval_step_quantizes_nothing_and_the_train_step_every_conv(models, monkeypatch):
    """No quantization without a gradient (the eval step runs under
    no_grad, as JAX's custom_vjp runs its primal): F and F′ stay idle. The
    train step quantizes and dequantizes once per U-Net convolution call."""
    from torch_mp import tiny_cfg

    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.models.layers import EDMConv
    from probunet_tpu_torch.train.loop import make_eval_step, make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    _, params = models
    counts = {"q": 0, "dq": 0}
    q_real, dq_real = tac.quantize_channels, tac.dequantize

    def q_count(*a, **kw):
        counts["q"] += 1
        return q_real(*a, **kw)

    def dq_count(*a, **kw):
        counts["dq"] += 1
        return dq_real(*a, **kw)

    monkeypatch.setattr(tac, "quantize_channels", q_count)
    monkeypatch.setattr(tac, "dequantize", dq_count)
    model = torch_tiny_model(params, dropout=DROPOUT, gn_impl="composed",
                             img_resolution=RES, act_compress=True)
    cfg = tiny_cfg(B, M, resolution=RES)
    hr = torch.from_numpy(_batch()[1])
    stats = compute_stats(hr, cfg.data.lowres_scale)
    make_eval_step(model, cfg)(hr, stats, torch.Generator().manual_seed(0))
    assert counts == {"q": 0, "dq": 0}
    calls = []
    hooks = [m.register_forward_hook(lambda mod, a, out: calls.append(len(a) > 1))
             for m in model.unet.modules() if isinstance(m, EDMConv) and m.kernel]
    state = create_train_state(model, seed=0, device="cpu")
    make_train_step(model, cfg)(state, hr, stats, 1.0, 0.1)
    for h in hooks:
        h.remove()
    n = len(calls) + sum(calls)   # a split convolution quantizes both inputs
    assert counts == {"q": n, "dq": n} and n > 0


def test_entry_points_read_the_environment(monkeypatch):
    """``cli.make_model``/``make_det_model`` (the models of ``train``,
    ``train-det`` and ``bench``) under PROBUNET_ACT_COMPRESS=int8, as the
    JAX package reads it, and ``Trainer`` on ``train``'s model; off
    otherwise."""
    from torch_mp import tiny_cfg

    from probunet_tpu_torch import cli
    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.models.layers import EDMConv
    from probunet_tpu_torch.train.loop import Trainer

    def flags(model):
        return {m.act_compress for m in model.modules() if isinstance(m, EDMConv)}

    cfg = tiny_cfg(2, 2)
    assert not tac.enabled() and flags(cli.make_model(cfg, "cpu")) == {False}
    monkeypatch.setenv("PROBUNET_ACT_COMPRESS", "int8")
    assert tac.enabled()
    assert flags(cli.make_model(cfg, "cpu")) == {True}
    assert flags(cli.make_det_model(cfg, "unet", "cpu")) == {True}
    ds = ClimexDataset(hr=np.ones((4, 16, 16, 3), np.float32), variables=cfg.data.variables,
                       pipeline=cfg.data.pipeline, lowres_scale=4, device="cpu")
    assert flags(Trainer(cfg, cli.make_model(cfg, "cpu"), ds, device="cpu").model) == {True}
    monkeypatch.setenv("PROBUNET_ACT_COMPRESS", "fp8")
    assert not tac.enabled()
