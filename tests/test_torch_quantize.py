"""The port's int8 serving (``probunet_tpu_torch/ops/quantize.py``, kernel
E's plain version, the hooks of ``EDMConv`` and ``_Conv3x3``, the eval
step's ``quant=``) against the JAX package's ``ops/quantize.py`` on the
CPU, on the same numpy inputs and converted weights.

Tolerances, and why:

- the primitives (``weight_scales``, ``quantize_int8``, ``int8_conv``, the
  trees): equal exactly. The int32 sums are exact in both packages, and
  every rounding point (the f32 division, ties to even, the clip at ±127,
  the scale product taken first, ``y1 + y2`` before the bias) is the JAX
  package's, so the outputs are bit-equal too;
- calibrated trees: the same paths, the first convolution's scale exact
  (its input is the model input itself), the others within 1e-5 relative
  (their inputs went through both frameworks' float convolutions and
  GroupNorms, which differ in the last bits: the model tolerance);
- served outputs: a float input within those last bits of a rounding
  boundary quantizes to the neighbouring int8 value in one package, so the
  served results are not bit-equal. The gap between the port's int8 result
  and JAX's must be at most a tenth of the gap between JAX's int8 and
  JAX's float results (max abs differences); measured here: 0.036 of
  that gap for the prior ensemble (one flipped rounding in the U-Net), the
  eval ELBO equal to JAX's. The bound is this model's and noise's: flips
  can cascade through the quantized convolutions (on the flagship at
  random weights, the port's two GroupNorm routes give int8 ensembles 0.66
  of the gap apart on one CPU, as ``chip_smoke.py``'s
  ``int8_device_vs_cpu`` prints), so the convolutions themselves are held
  bit for bit above;
- the float path with no tree attached: bit-equal to the float path of a
  model that never saw a tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, noisy_params
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.convert import convert_quant, flax_quant, load_params
from probunet_tpu_torch.ops import quantize as tq
from probunet_tpu_torch.ops.kernels import int8_conv as E

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SERVE_SHARE = 0.1     # port-vs-JAX int8 gap over the JAX int8-vs-float gap
CALIB_RTOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _hwio(w_oihw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_oihw.transpose(2, 3, 1, 0))


# ---------------------------------------------------------------------------
# Primitives against the JAX functions
# ---------------------------------------------------------------------------

def test_weight_scales_match_jax():
    from probunet_tpu.ops import quantize as jq

    w = _rng(0).standard_normal((6, 5, 3, 3)).astype(np.float32)
    w[2] = 0.0                                   # an all-zero channel: the 1e-12 floor
    got = tq.weight_scales(torch.from_numpy(w)).numpy()
    want = np.asarray(jq.weight_scales(jnp.asarray(_hwio(w))))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax_ties_and_clipping(dtype):
    from probunet_tpu.ops import quantize as jq

    scale = np.float32(0.25)                     # x / scale exact: the ties are exact
    k = np.arange(-140, 141, dtype=np.float32)
    x = np.concatenate([(k + 0.5) * scale, k * scale, [1e6, -1e6, 31.9, -31.9]]).astype(
        np.float32)
    x = np.concatenate([x, _rng(1).standard_normal(997).astype(np.float32) * 20])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    got = tq.quantize_int8(tx, torch.tensor(scale)).numpy()
    want = np.asarray(jq.quantize_int8(jx, jnp.float32(scale)))
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert got.min() == -127 and got.max() == 127
    # ties to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    q = tq.quantize_int8(torch.tensor([0.5, 1.5, -2.5, 2.5]) * 0.25, 0.25)
    assert q.tolist() == [0, 2, -2, 2]


def _jax_acc(x_nhwc, w_oihw, in_scale):
    from probunet_tpu.ops import quantize as jq

    s_w = jq.weight_scales(jnp.asarray(_hwio(w_oihw)))
    w_q = jq.quantize_int8(jnp.asarray(_hwio(w_oihw)), s_w[None, None, None, :])
    x_q = jq.quantize_int8(x_nhwc, jnp.float32(in_scale))
    pad = w_oihw.shape[-1] // 2
    return np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, (1, 1), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))


CONV_CASES = [  # (x shape NHWC, cout, k, cin of a second input or 0)
    ((2, 9, 7, 3), 8, 3, 0),
    ((2, 8, 8, 16), 12, 3, 0),
    ((3, 6, 5, 6), 8, 1, 0),
    ((2, 1, 1, 32), 4, 1, 0),
    ((2, 8, 8, 16), 8, 1, 8),
    ((2, 6, 7, 8), 16, 3, 12),
    ((2, 7, 9, 40), 24, 3, 0),      # cin off a 32-channel chunk, cout off a block
    ((2, 7, 9, 24), 264, 1, 16),    # a split convolution wider than a block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[f"{c[0]}-{c[1]}-k{c[2]}-x2{c[3]}"
                                                  for c in CONV_CASES])
def test_int8_conv_matches_jax_bit_for_bit(case, dtype):
    """The int32 sums equal exactly, the f32 outputs bit for bit: the
    primitive (one input) and a split convolution, whose JAX form is
    ``int8_conv(x, w[..., :c1, :]) + int8_conv(x2, w[..., c1:, :])``, each
    slice with its own per-channel scales."""
    from probunet_tpu.ops import quantize as jq

    (n, h, w_, cin), cout, k, cin2 = case
    rng = _rng(CONV_CASES.index(case))
    x = rng.standard_normal((n, h, w_, cin)).astype(np.float32) * 2
    w = (rng.standard_normal((cout, cin + cin2, k, k)) * 0.3).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    s1 = np.float32(np.abs(tx.float().numpy()).max() / 127)
    qw = E.quantize_weight(torch.from_numpy(w[:, :cin]))
    if not cin2:
        got, acc = E.int8_conv(tx, qw, torch.tensor(s1), out_dtype=torch.float32,
                               return_acc=True)
        want = np.asarray(jq.int8_conv(jx, jnp.asarray(_hwio(w)), jnp.float32(s1), k // 2))
        assert np.array_equal(acc[0].numpy(), _jax_acc(jx, w, s1))
        assert np.array_equal(tq.int8_conv(tx, torch.from_numpy(w), s1, k // 2).numpy(), want)
    else:
        x2 = rng.standard_normal((n, h, w_, cin2)).astype(np.float32)
        tx2 = torch.from_numpy(x2).to(tdt)
        jx2 = jnp.asarray(x2).astype(jdt)
        s2 = np.float32(0.7 * np.abs(tx2.float().numpy()).max() / 127)
        qw2 = E.quantize_weight(torch.from_numpy(w[:, cin:]))
        got, acc = E.int8_conv(tx, qw, s1, x2=tx2, qw2=qw2, in_scale2=s2,
                               out_dtype=torch.float32, return_acc=True)
        jw = jnp.asarray(_hwio(w))
        want = np.asarray(jq.int8_conv(jx, jw[:, :, :cin, :], jnp.float32(s1), k // 2)
                          + jq.int8_conv(jx2, jw[:, :, cin:, :], jnp.float32(s2), k // 2))
        assert np.array_equal(acc[0].numpy(), _jax_acc(jx, w[:, :cin], s1))
        assert np.array_equal(acc[1].numpy(), _jax_acc(jx2, w[:, cin:], s2))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_epilogue_adds_the_bias_in_f32_and_casts_like_jax(dtype):
    """The layer's epilogue: (y1 + y2 + b) in f32, cast to x's dtype, as
    ``EDMConv``'s int8 branch in the JAX package."""
    from probunet_tpu.ops import quantize as jq

    rng = _rng(5)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    x2 = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    w = (rng.standard_normal((8, 12, 3, 3)) * 0.3).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tx2 = (torch.from_numpy(a).to(tdt) for a in (x, x2))
    got = E.int8_conv(tx, E.quantize_weight(torch.from_numpy(w[:, :8])), 0.03,
                      torch.from_numpy(b), x2=tx2,
                      qw2=E.quantize_weight(torch.from_numpy(w[:, 8:])), in_scale2=0.02)
    jw = jnp.asarray(_hwio(w))
    jx, jx2 = (jnp.asarray(a).astype(jdt) for a in (x, x2))
    y = (jq.int8_conv(jx, jw[:, :, :8, :], jnp.float32(0.03), 1)
         + jq.int8_conv(jx2, jw[:, :, 8:, :], jnp.float32(0.02), 1))
    want = np.asarray((y + jnp.asarray(b)).astype(jdt).astype(jnp.float32))
    assert got.dtype == tdt and np.array_equal(got.float().numpy(), want)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(_rng(0).standard_normal((64, 64)).astype(np.float32) * 3)
    scale = x.abs().max() / 127
    q = tq.quantize_int8(x, scale)
    assert q.dtype == torch.int8 and int(q.min()) >= -127
    assert float((q.float() * scale - x).abs().max()) <= float(scale) / 2 + 1e-6


def test_weight_scales_per_channel():
    w = torch.stack([torch.full((4, 3, 3), 0.5), torch.full((4, 3, 3), 2.0)])
    assert_close(tq.weight_scales(w).numpy(), [0.5 / 127, 2.0 / 127], 1e-6)


def test_int8_conv_matches_the_float_oracle():
    rng = _rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 8)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((16, 8, 3, 3)) * 0.1).astype(np.float32))
    y_q = tq.int8_conv(x, w, x.abs().max() / 127, 1)
    y_f = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    assert float((y_q - y_f).norm() / y_f.norm()) < 0.02


def test_int8_conv_exact_on_grid_values():
    """Inputs and weights on the int8 grid, each output channel's absmax
    127, so both scales are 1.0 and nothing is lost."""
    rng = _rng(2)
    x = torch.from_numpy(np.clip(np.round(rng.standard_normal((1, 8, 8, 4)) * 20), -127, 127)
                         .astype(np.float32))
    w = np.clip(np.round(rng.standard_normal((4, 4, 3, 3)) * 20), -127, 127).astype(np.float32)
    w[:, 0, 0, 0] = 127.0
    w = torch.from_numpy(w)
    y_q = tq.int8_conv(x, w, 1.0, 1)
    y_f = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    assert torch.equal(y_q, y_f)


def test_wrapper_refuses_a_non_cpu_tensor_without_the_kernel():
    qw = E.quantize_weight(torch.ones(4, 3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        E.int8_conv(torch.empty(1, 4, 4, 3, device="meta"), qw, 0.1)
    assert E.int8_conv.launches == 0


def _jax_tree(tree):
    return jax.tree.map(lambda v: jnp.float32(float(v)), tree)


def test_trees_match_jax():
    from probunet_tpu.ops import quantize as jq

    stats_a = {"unet": {"c0": {"absmax": 2.0, "absmax2": 0.0}, "c1": {"absmax": 5.0}},
               "prior": {"conv_mu": {"absmax": 1.0}, "conv_log_sigma": {"absmax": 3.0},
                         "enc0_conv0": {"absmax": 127.0}}}
    stats_b = jax.tree.map(lambda v: v * 1.5 if v != 127.0 else 1.0, stats_a)
    ta, tb = (jax.tree.map(lambda v: torch.tensor(np.float32(v)), s) for s in (stats_a, stats_b))
    merged = tq.merge_stats(ta, tb)
    want = jq.merge_stats(_jax_tree(stats_a), _jax_tree(stats_b))
    assert jax.tree.map(float, flax_quant(merged)) == jax.tree.map(float, want)
    scales = tq.quant_scales_from_stats(merged)
    want_s = jq.quant_scales_from_stats(want)
    assert flax_quant(scales) == jax.tree.map(lambda v: np.float32(v), want_s)
    assert float(scales["unet"]["c0"]["in_scale2"]) == np.float32(1e-12) / np.float32(127)
    for pats in (["heads"], [r"^prior/"], ["c1", "enc0"], [r"in_scale2$"], None):
        got = tq.quant_skip(scales, pats)
        ref = jq.quant_skip(want_s, pats)
        assert jax.tree.map(float, flax_quant(got)) == jax.tree.map(float, ref), pats
    assert "prior" not in tq.quant_skip(scales, [r"^prior/"])
    assert tq.quant_skip(scales, None) is scales
    assert len(tq.tree_leaves(tq.quant_skip(scales, ["heads"]))) == 4
    with pytest.raises(ValueError, match="differ"):
        tq.merge_stats(ta, {"unet": tb["unet"]})


# ---------------------------------------------------------------------------
# The model: calibration and serving against the JAX package
# ---------------------------------------------------------------------------

TINY_Q = dict(input_channels=2, num_classes=2, latent_dim=4, num_filters=(8, 16),
              model_channels=16, channel_mult=(1, 2), img_resolution=(32, 32), num_blocks=1)


@pytest.fixture(scope="module")
def qmodels():
    """(JAX model, noisy params, the port's model on the composed GroupNorm
    route, the JAX default's counterpart): ``tests/test_quantize.py``'s tiny
    model."""
    from flax.core import unfreeze

    from probunet_tpu.models.prob_unet import ProbabilisticUNet as JaxPU
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    jmodel = JaxPU(**TINY_Q)
    x = jnp.zeros((1, 32, 32, 2))
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k, "latent": k}, x, x),
                            jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       unfreeze(shapes["params"])), seed=11)
    model = ProbabilisticUNet(generator=torch.Generator().manual_seed(0), gn_impl="composed",
                              **TINY_Q)
    return jmodel, params, load_params(model, params).eval()


def _x(seed, b=2):
    return _rng(seed).standard_normal((b, 32, 32, 2)).astype(np.float32)


def _jax_serve(jmodel, params, x, eps, scales=None):
    """JAX's prior ensemble with the prior noise given (the
    ``_jax_sampler`` of test_torch_cli.py), int8 where ``scales`` is."""
    def decode(mdl, x, eps):
        feats, prior, _ = mdl.encode(x)
        return mdl.decode(feats, prior.mu + prior.sigma * eps)

    variables = {"params": jax.tree.map(jnp.asarray, params)}
    if scales is not None:
        variables["quant"] = scales
    return np.asarray(jax.jit(lambda v, x, e: jmodel.apply(v, x, e, method=decode))(
        variables, jnp.asarray(x), jnp.asarray(eps)))


def _check_tree(got, want):
    """Same paths; the first convolution's scale exact, the rest within
    CALIB_RTOL."""
    g = {"/".join(p): v for p, v in _paths(got)}
    w = {"/".join(p): v for p, v in _paths(want)}
    assert sorted(g) == sorted(w)
    for key in ("unet/enc_32x32_conv/in_scale", "prior/enc0_conv0/in_scale"):
        assert g[key] == w[key], key
    assert_close([g[k] for k in sorted(g)], [w[k] for k in sorted(g)], CALIB_RTOL,
                 what="calibrated scales")


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.float32(np.asarray(v))


@pytest.fixture(scope="module")
def calibrated(qmodels):
    """(JAX's sample-path scales, the port's, the calibration inputs)."""
    from probunet_tpu.models.prob_unet import ProbabilisticUNet as JaxPU  # noqa: F401
    from probunet_tpu.ops.quantize import calibrate_sample

    jmodel, params, model = qmodels
    xs = [_x(i) for i in range(3)]
    jscales = calibrate_sample(jmodel, jax.tree.map(jnp.asarray, params),
                               [jnp.asarray(x) for x in xs], num_samples=2)
    scales = tq.calibrate_sample(model, [torch.from_numpy(x) for x in xs], num_samples=2)
    return jax.device_get(jscales), scales, xs


def test_calibrate_sample_matches_jax(qmodels, calibrated):
    jscales, scales, _ = calibrated
    _check_tree(scales, jscales)
    n = len(tq.tree_leaves(scales))
    n2 = sum(1 for p, _ in _paths(scales) if p[-1] == "in_scale2")
    # every hooked convolution of the sample path: the U-Net's and the prior's
    model = qmodels[2]
    hooked = tq.hooked_convs(model)
    sample_convs = [p for p in hooked if not p.startswith("posterior/")]
    assert n - n2 == len(sample_convs) and n2 > 0


def test_calibrate_elbo_matches_jax(monkeypatch):
    """The eval ELBO's calibration (U-Net, prior and posterior) on the
    ``probunet_latent6_64`` cut of ``tests/test_quantize.py``."""
    from flax.core import unfreeze

    from probunet_tpu.cli import make_model
    from probunet_tpu.config import preset as jpreset
    from probunet_tpu.data.climex import compute_stats as jstats
    from probunet_tpu.ops.quantize import calibrate_elbo

    from probunet_tpu_torch.config import preset
    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    monkeypatch.setenv("PROBUNET_FUSED_ELBO", "0")
    over = {"data.resolution": (16, 16), "data.lowres_scale": 4, "model.num_filters": (8, 16),
            "model.model_channels": 8, "model.channel_mult": (1, 2), "model.num_blocks": 1,
            "model.latent_dim": 4, "train.eval_ensemble_size": 2}
    jcfg, tcfg = jpreset("probunet_latent6_64").override(over), preset(
        "probunet_latent6_64").override(over)
    jmodel = make_model(jcfg)
    x = jnp.zeros((1, 16, 16, 1))
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k, "latent": k}, x, x),
                            jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       unfreeze(shapes["params"])), seed=4)
    from probunet_tpu.data.synthetic import synthetic_climex_fields
    hr = synthetic_climex_fields(8, 16, 16, jcfg.data.variables, seed=0)
    jscales = calibrate_elbo(jmodel, jax.tree.map(jnp.asarray, params),
                             [jnp.asarray(hr[:4]), jnp.asarray(hr[4:])], jcfg,
                             jstats(jnp.asarray(hr), 4))
    model = load_params(ProbabilisticUNet.from_config(
        tcfg, torch.Generator().manual_seed(0), device="cpu", gn_impl="composed"), params)
    th = torch.from_numpy(hr)
    scales = tq.calibrate_elbo(model.eval(), [th[:4], th[4:]], tcfg, compute_stats(th, 4))
    g = {"/".join(p): v for p, v in _paths(scales)}
    w = {"/".join(p): v for p, v in _paths(jax.device_get(jscales))}
    assert sorted(g) == sorted(w) and any(k.startswith("posterior/") for k in g)
    assert g["unet/enc_16x16_conv/in_scale"] == w["unet/enc_16x16_conv/in_scale"]
    assert_close([g[k] for k in sorted(g)], [w[k] for k in sorted(g)], CALIB_RTOL)

    # the eval ELBO served int8 against JAX's make_eval_step(quant=), on the
    # same posterior noise
    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.train.loop import make_eval_step as jax_eval_step

    from probunet_tpu_torch.train.loop import make_elbo_loss_fn, make_eval_step

    eps = _rng(9).standard_normal((2, 4, 4)).astype(np.float32)
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * eps)
    jstats_ = jstats(jnp.asarray(hr), 4)
    jp = jax.tree.map(jnp.asarray, params)
    jf = float(jax_eval_step(jmodel, jcfg)(jp, jax.random.key(5), jnp.asarray(hr[:4]),
                                           jstats_)["loss"])
    jq_ = float(jax_eval_step(jmodel, jcfg, quant=jscales)(jp, jax.random.key(5),
                                                           jnp.asarray(hr[:4]), jstats_)["loss"])
    tstats = compute_stats(th, 4)
    port_scales = convert_quant(jax.device_get(jscales), model)
    loss_fn = make_elbo_loss_fn(model, tcfg, training=False, fused=False, quant=port_scales)
    with torch.no_grad():
        tq_ = float(loss_fn(th[:4], tstats, None, 1.0, 0.0, eps=torch.from_numpy(eps))[0])
    assert abs(tq_ - jq_) <= SERVE_SHARE * abs(jq_ - jf), (tq_, jq_, jf)
    print(f"eval ELBO int8: port {tq_!r}, JAX {jq_!r}, JAX float {jf!r}")
    step = make_eval_step(model, tcfg, fused=False, quant=port_scales)
    out = step(th[:4], tstats, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in out.values())
    assert all(mod.quant_scales is None for mod in tq.hooked_convs(model).values())


def test_served_int8_sample_matches_jax(qmodels, calibrated):
    """JAX's calibrated tree converted to the port, the prior noise shared:
    the port's int8 ensemble within a tenth of JAX's int8-vs-float gap;
    with the heads pruned too, the heads then on their float path."""
    from probunet_tpu.ops.quantize import quant_skip as jax_skip

    jmodel, params, model = qmodels
    jscales, _, _ = calibrated
    x = _x(7)
    eps = _rng(8).standard_normal((3, 2, 4)).astype(np.float32)
    j_float = _jax_serve(jmodel, params, x, eps)
    int8_calls = []
    forward = tq.int8_forward

    def counting(mod, *a):
        int8_calls.append(mod)
        return forward(mod, *a)

    for skip in (None, ["heads"]):
        jtree = jax_skip(jscales, skip)
        j_int8 = _jax_serve(jmodel, params, x, eps, jax.tree.map(jnp.asarray, jtree))
        int8_calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tq, "int8_forward", counting)
            with tq.attached(model, convert_quant(jtree, model)), torch.no_grad():
                got = model.sample(torch.from_numpy(x), 3, eps=torch.from_numpy(eps)).numpy()
        gap = np.abs(j_int8 - j_float).max()
        print(f"skip={skip}: port-vs-JAX int8 {np.abs(got - j_int8).max()!r}, JAX int8-vs-float "
              f"{gap!r}")
        assert gap > 0
        assert np.abs(got - j_int8).max() <= SERVE_SHARE * gap, (np.abs(got - j_int8).max(), gap)
        names = {n for n, m in tq.hooked_convs(model).items() for c in int8_calls if c is m}
        heads = {"prior/conv_mu", "prior/conv_log_sigma"}
        sample_convs = {p for p in tq.hooked_convs(model) if not p.startswith("posterior/")}
        assert names == (sample_convs - heads if skip else sample_convs)


def test_float_path_bit_equal_without_a_tree(qmodels, calibrated):
    jmodel, params, model = qmodels
    _, scales, _ = calibrated
    x, eps = torch.from_numpy(_x(3)), torch.from_numpy(
        _rng(4).standard_normal((2, 2, 4)).astype(np.float32))
    with torch.no_grad():
        before = model.sample(x, 2, eps=eps)
        with tq.record_absmax(model):
            recorded = model.sample(x, 2, eps=eps)
        with tq.attached(model, scales):
            served = model.sample(x, 2, eps=eps)
        after = model.sample(x, 2, eps=eps)
    assert torch.equal(before, recorded) and torch.equal(before, after)
    assert not torch.equal(before, served)
    assert_close(before.numpy(), _jax_serve(jmodel, params, x.numpy(), eps.numpy()), 1e-4, 1e-5)


def test_int8_route_raises_under_grad(qmodels, calibrated):
    _, _, model = qmodels
    _, scales, _ = calibrated
    x = torch.from_numpy(_x(1))
    with tq.attached(model, scales):
        with pytest.raises(RuntimeError, match="no gradient"):
            model.sample(x, 2, eps=torch.zeros(2, 2, 4))
        with torch.no_grad():
            assert torch.isfinite(model.sample(x, 2, eps=torch.zeros(2, 2, 4))).all()
    model.sample(x, 1, eps=torch.zeros(1, 2, 4)).sum().backward()   # the float path differentiates
    model.zero_grad()


def test_attach_and_convert_refuse_paths_that_name_no_convolution(qmodels, calibrated):
    _, _, model = qmodels
    _, scales, _ = calibrated
    for bad in ({"unet": {"nowhere": {"in_scale": 0.1}}},
                {"prior": {"conv_mu": {"weight": 0.1}}},
                {"fcomb": {"in_scale": 0.1}},
                {"unet": {"enc_32x32_block0": {"norm0": {"in_scale": 0.1}}}}):
        with pytest.raises(ValueError, match="no hooked convolution"):
            tq.attach(model, bad)
        with pytest.raises(ValueError, match="no hooked convolution"):
            convert_quant(bad, model)
    assert all(m.quant_scales is None for m in tq.hooked_convs(model).values())
    back = convert_quant(flax_quant(scales), model)
    assert flax_quant(back) == flax_quant(scales)
