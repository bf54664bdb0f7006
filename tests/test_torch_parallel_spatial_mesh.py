"""The spatially sharded paths of the port on four gloo ranks spawned on
the CPU (``tests/torch_mp.py``, one spawn for the file): the train step
on a 2 x 2 ("data", "spatial") mesh and the serve path's sample step on a
1 x 2 x 2 ("data", "spatial", "member") mesh, against the JAX package;
and, in this process, the pieces that make a block of rows compute what
the whole image computes: the split plain versions of kernels C/C′
against the whole-image ones, the keep masks of C (shifted seed words)
and D (the block mapping) against the global masks' rows, the block
checks and the one option still deferred (self-attention).

Tolerances:
- the 2 x 2 train step against JAX's one-device step (dropout 0, the
  same posterior noise): loss, recon, kl_mean and grad_norm rtol 1e-4,
  the parameters rtol 2e-3 / atol 2e-5 (JAX ``tests/test_parallel.py:83``);
  with dropout 0.1 against the port's one-process step: metrics rtol
  1e-5, the gradients within 1e-5 of the largest;
- the sample step against JAX's on a ("data", "spatial", "member") mesh,
  the same noise: rtol / atol 1e-4 on HR fields of magnitude up to ~4 (as
  ``test_torch_parallel_steps.py``'s member test: the model through two
  libraries' convolutions); int8 (rank 0's scales on every rank) against
  the port's one-process int8 sample: each int8 convolution of a block is
  exact (``test_torch_parallel_spatial_steps.py``), but the blocks'
  GroupNorm sums, added in another order, move an input of a later
  convolution across a rounding boundary of its quantization now and
  then, and the next GroupNorm spreads that step over the image (this
  8-channel model: the first such step at ``dec_16x16_in1.conv0``, 0.010).
  So the sharded int8 ensemble is held to the one-process one by its
  distance from the float ensemble (the two means within 1% of each
  other), its mean difference (at most a quarter of the mean
  int8-vs-float gap, 0.15 measured) and its largest (at most the largest
  gap);
- the split plain versions against the whole-image plain versions: masks
  bit for bit, values rtol 1e-5 / atol 1e-6 in f32 (the block's partial
  sums add in another order); keep masks bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_mp import spawn, tiny_cfg
from torch_parity import assert_close, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)
from torch_spatial import (
    B,
    DROPOUT,
    M,
    RES,
    RESOLUTION,
    assert_grads_close,
    assert_metrics_close,
    assert_ranks_agree,
    hr_fields,
    jax_cfg,
    jax_train_step,
    one_process,
    params,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

WORLD = 4
M_SAMPLE = 4
LOSS_RTOL = 1e-4
JAX_PARAM_RTOL, JAX_PARAM_ATOL = 2e-3, 2e-5
RTOL = 1e-5
SAMPLE_RTOL, SAMPLE_ATOL = 1e-4, 1e-4
PLAIN_RTOL, PLAIN_ATOL = 1e-5, 1e-6
INT8_MEAN_SHARE, INT8_GAP_SHARE = 0.25, 0.01


def _stats(hr: np.ndarray):
    from probunet_tpu_torch.data.climex import compute_stats

    st = compute_stats(torch.from_numpy(hr), 4)
    return tuple(None if a is None else a.numpy() for a in st)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(8)
    hr_normal = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    return {"hr": hr_fields(31), "eps": rng.standard_normal((M, B, 4)).astype(np.float32),
            # standard normal fields, as JAX's member tests
            "hr_normal": hr_normal, "stats_normal": _stats(hr_normal),
            "eps_sample": rng.standard_normal((M_SAMPLE, B, 4)).astype(np.float32)}


def _int8_scales(inputs):
    """Scales calibrated on the one-process sample path (rank 0's, as
    every rank of the sharded step uses them)."""
    from probunet_tpu_torch.data.climex import Standardization, preprocess_batch
    from probunet_tpu_torch.ops import quantize

    model = torch_tiny_model(params(), img_resolution=RESOLUTION)
    stats = Standardization(*(None if a is None else torch.from_numpy(a)
                              for a in inputs["stats_normal"]))
    cfg = tiny_cfg(B, M_SAMPLE, resolution=RESOLUTION)
    batch = preprocess_batch(torch.from_numpy(inputs["hr_normal"]), stats, cfg.data.pipeline, 4)
    return quantize.calibrate_sample(model, [batch["inputs"]], M_SAMPLE)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    wd = tmp_path_factory.mktemp("parallel_spatial_mesh")
    base = dict(hr=inputs["hr"], m=M, fused=True, n_data=2, n_spatial=2)
    steps = [dict(base, name="jax", dropout=0.0, gn_impl="composed", eps=inputs["eps"],
                  steps=1),
             dict(base, name="dropout kernel", dropout=DROPOUT, gn_impl="kernel", eps=None,
                  steps=1)]
    torch.save({"params": params(), "cases": steps}, wd / "spatial_step.in.pt")
    sample = dict(hr=inputs["hr_normal"], eps=inputs["eps_sample"], n_member=2, n_spatial=2,
                  stats=inputs["stats_normal"])
    member = [dict(sample, name=std, standardization=std)
              for std in ("perpixel", "pertimestep")]
    member.append(dict(sample, name="int8", standardization="perpixel",
                       quant=_int8_scales(inputs)))
    torch.save({"params": params(), "cases": member}, wd / "spatial_member.in.pt")
    jobs = ("spatial_step", "spatial_member")
    spawn(list(jobs), wd, world=WORLD, timeout=300)
    return {job: [torch.load(wd / f"{job}.rank{r}.pt", weights_only=False)
                  for r in range(WORLD)] for job in jobs}


def test_spatial_2x2_step_matches_jax(inputs, runs, monkeypatch):
    """make_parallel_train_step on a 2 x 2 ("data", "spatial") mesh (each
    rank 4 items x 16 rows) against JAX's make_train_step on one device."""
    assert_ranks_agree([r["jax"] for r in runs["spatial_step"]])
    got = runs["spatial_step"][0]["jax"]
    met, want = jax_train_step(monkeypatch, inputs["hr"], inputs["eps"])
    assert_metrics_close(got["metrics"][0], met, LOSS_RTOL, "2x2 vs JAX")
    for k, v in want.items():
        assert_close(got["params"][k], v, JAX_PARAM_RTOL, JAX_PARAM_ATOL, k)


def test_spatial_2x2_step_with_dropout_matches_single_process(inputs, runs):
    """Dropout 0.1 on the kernel route over the 2 x 2 mesh: the masks of
    the global rows (seed words shifted by both the batch and the row
    offset), the one-process step's metrics and gradients."""
    outs = [r["dropout kernel"] for r in runs["spatial_step"]]
    assert_ranks_agree(outs)
    case = dict(hr=inputs["hr"], m=M, fused=True, dropout=DROPOUT, gn_impl="kernel",
                eps=None, steps=1)
    mets, grads, _ = one_process(case)
    assert_metrics_close(outs[0]["metrics"][0], mets[0], RTOL, "2x2 dropout")
    assert_grads_close(outs[0]["grads"][0], grads[0], RTOL, "2x2 dropout")


@pytest.mark.parametrize("standardization", ["perpixel", "pertimestep"])
def test_spatial_sample_step_matches_jax(inputs, runs, monkeypatch, standardization):
    """make_parallel_sample_step on a 1 x 2 x 2 ("data", "spatial",
    "member") mesh: every rank encodes its block of rows (the encoders'
    pool summed over "spatial"; pertimestep item statistics of the whole
    image), decodes its member slice, and the gathered ensemble is JAX's
    on a 2 x 2 x 2 mesh of the suite's 8 devices, the same noise
    (``test_parallel.py:361,449``)."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import compute_stats
    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.parallel import make_member_mesh, make_parallel_sample_step

    jmodel, p = jax_tiny_model(img_resolution=RESOLUTION)
    eps = jnp.asarray(inputs["eps_sample"])
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * eps)
    cfg = jax_cfg(B, M_SAMPLE, standardization=standardization)
    step = make_parallel_sample_step(jmodel, cfg, make_member_mesh(n_member=2, n_spatial=2),
                                     num_samples=M_SAMPLE)
    hr = inputs["hr_normal"]
    want = np.asarray(step(jax.tree.map(jnp.asarray, p), hr, jax.random.key(0),
                           compute_stats(jnp.asarray(hr), 4)))
    assert want.shape == (B, M_SAMPLE, RES, RES, 3)
    outs = [r[standardization] for r in runs["spatial_member"]]
    assert_ranks_agree(outs)
    assert tuple(outs[0].shape) == want.shape and np.isfinite(outs[0].numpy()).all()
    assert_close(outs[0], want, SAMPLE_RTOL, SAMPLE_ATOL, standardization)


def test_spatial_int8_sample_matches_single_process(inputs, runs):
    """The int8 sample step on the 1 x 2 x 2 mesh (kernel E's plain version
    SAME on each halo-padded block, the outer rows cropped) against the
    port's one-process int8 sample on the same scales and noise."""
    from probunet_tpu_torch.data.climex import (Standardization, lrinterp_from_batch,
                                                preprocess_batch, residual_to_hr)
    from probunet_tpu_torch.ops import quantize

    outs = [r["int8"] for r in runs["spatial_member"]]
    assert_ranks_agree(outs)
    model = torch_tiny_model(params(), img_resolution=RESOLUTION)
    stats = Standardization(*(None if a is None else torch.from_numpy(a)
                              for a in inputs["stats_normal"]))
    batch = preprocess_batch(torch.from_numpy(inputs["hr_normal"]), stats,
                             "lrinterp_to_residuals", 4)
    eps = torch.from_numpy(inputs["eps_sample"])
    lr = lrinterp_from_batch(batch, 4)[:, None]

    def served(quant):
        with torch.no_grad(), quantize.attached(model, quant):
            out = model.sample(batch["inputs"], M_SAMPLE, eps=eps)
        return residual_to_hr(out, lr, stats)

    want, float_out = served(_int8_scales(inputs)), served(None)
    gap = (want - float_out).abs()
    got_gap = (outs[0] - float_out).abs()
    err = (outs[0] - want).abs()
    assert float(gap.mean()) > 0 and float(err.max()) <= float(gap.max())
    assert float(err.mean()) <= INT8_MEAN_SHARE * float(gap.mean())
    assert abs(float(got_gap.mean()) - float(gap.mean())) <= INT8_GAP_SHARE * float(gap.mean())


# ---------------------------------------------------------------------------
# In this process: the split kernels' plain versions and the masks
# ---------------------------------------------------------------------------

def _chain(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    return (torch.randn(shape, generator=g).to(dtype), 1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g), 0.1 * torch.randn((b, c), generator=g),
            0.1 * torch.randn((b, c), generator=g),
            torch.tensor([123456789, -98765], dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_split_c_plain_versions_give_the_whole_images_rows(dtype, n):
    """Split C and C′ (plain versions) on each of n blocks of rows of a
    (3, 16, 8, 32) chain, 8 groups, p = 0.3, each block under seed words
    shifted to its first element and its partial sums summed with the
    other blocks' (the ranks' all-reduce): the whole image's mean, rstd, y
    and dx rows, and its parameter gradients summed over the blocks; the
    masks bit for bit."""
    from probunet_tpu_torch.ops.kernels import fused_gn as tgn

    shape = (3, 16, 8, 32)
    x, gamma, beta, scale, shift, seed = _chain(shape, dtype)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(9)).to(dtype)
    consts = (8, 1e-5, 0.3, True)
    y, mean, rstd = tgn.gn_film_silu_dropout_plain(x, gamma, beta, scale, shift, seed, *consts)
    grads = tgn.gn_film_silu_dropout_bwd_plain(x, g, gamma, beta, scale, shift, seed, mean,
                                               rstd, 8, 0.3, True)
    h = shape[1] // n
    blocks = [slice(i * h, (i + 1) * h) for i in range(n)]
    seeds = [tgn.slab_seed(seed, 0, r.start * shape[2] * shape[3]) for r in blocks]
    # every block's partials, then each block's sum of them all
    parts = []
    for r, s in zip(blocks, seeds):
        tgn.gn_split_fwd(x[:, r], gamma, beta, scale, shift, s, *consts, shape[1],
                         lambda t: parts.append(t.clone()), r.start)
    total = sum(parts)
    bparts = []
    for r, s in zip(blocks, seeds):
        y_b, mean_b, rstd_b = tgn.gn_split_fwd(x[:, r], gamma, beta, scale, shift, s, *consts,
                                               shape[1], lambda t: t.copy_(total), r.start)
        tol = (2 ** -7, 2 ** -7) if dtype == torch.bfloat16 else (PLAIN_RTOL, PLAIN_ATOL)
        assert torch.equal(y_b == 0, y[:, r] == 0)
        assert_close(y_b.float(), y[:, r].float(), *tol, "y")
        assert_close(mean_b, mean, PLAIN_RTOL, PLAIN_ATOL, "mean")
        assert_close(rstd_b, rstd, PLAIN_RTOL, PLAIN_ATOL, "rstd")
        tgn.gn_split_bwd(x[:, r], g[:, r], gamma, beta, scale, shift, s, mean, rstd,
                         8, 0.3, True, shape[1], lambda t: bparts.append(t.clone()), r.start)
    btotal = sum(bparts)
    terms = []
    for r, s in zip(blocks, seeds):
        out = tgn.gn_split_bwd(x[:, r], g[:, r], gamma, beta, scale, shift, s, mean, rstd,
                               8, 0.3, True, shape[1], lambda t: t.copy_(btotal), r.start)
        tol = (2 ** -7, 2 ** -7) if dtype == torch.bfloat16 else (1e-4, 1e-5)
        assert_close(out[0].float(), grads[0][:, r].float(), *tol, "dx")
        terms.append(out[1:])
    for i, name in enumerate(("dgamma", "dbeta", "dscale", "dshift")):
        assert_close(sum(t[i] for t in terms), grads[1 + i], 1e-4, 1e-5, name)


def test_c_masks_of_a_block_of_rows_are_the_global_rows():
    """gn_keep of a block of rows under ``slab_seed(seed, b0, h0*W*C)`` is
    the global keep mask's block, for each block of a batch slab; without
    the row offset it is not. The second word wraps past 2^31 - 1."""
    from probunet_tpu_torch.ops.kernels import fused_gn as tgn

    b, h, w, c = 4, 16, 8, 24
    for seed in (torch.tensor([7, 11], dtype=torch.int32),
                 torch.tensor([5, 2**31 - 2], dtype=torch.int32)):
        whole = tgn.gn_keep((b, h, w, c), seed, 0.25)
        for b0 in (0, 2):
            for h0 in (0, 4, 12):
                got = tgn.gn_keep((2, 4, w, c), tgn.slab_seed(seed, b0, h0 * w * c), 0.25)
                assert torch.equal(got, whole[b0:b0 + 2, h0:h0 + 4]), (b0, h0)
        assert not torch.equal(tgn.gn_keep((2, 4, w, c), tgn.slab_seed(seed, 2), 0.25),
                               whole[2:, 4:8])
    assert tgn.slab_seed(seed, 0, 0) is seed


# the (H, W, C, G) of every GroupNorm chain of test_torch_parallel_spatial_steps.py's
# "kernel A" case (the tiny U-Net at 32x32, Fcomb width 32)
KERNEL_A_CHAINS = [(32, 32, 8, 2), (32, 32, 16, 4), (32, 32, 24, 6), (16, 16, 8, 2),
                   (16, 16, 16, 4), (16, 16, 24, 6), (16, 16, 32, 8)]
# largest |split - whole| over the largest |whole|, f32: the statistics and y
# read up to 1.5e-6 on this test's inputs (1.7e-6 on that case's own
# activations, tests/torch_parity_gaps.py), dx and the parameter terms 4.4e-7
# (2.2e-7)
SPLIT_STATS_TOL, SPLIT_GRADS_TOL = 4e-6, 1e-6


@pytest.mark.parametrize("chain", KERNEL_A_CHAINS, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("p_drop", [0.0, 0.1], ids=["p0", "p0.1"])
def test_split_c_agrees_with_the_whole_chain_at_the_kernel_a_shapes(chain, p_drop):
    """Split C and C′ (plain versions) on the two row blocks of each chain
    of the spatial step's "kernel A" case, B = 8, FiLM and SiLU on, half the
    channels' means 2.8 standard deviations from 0 (GroupNorm's cancellation):
    the keep masks of the blocks are the whole chain's bit for bit, and
    mean, rstd, y, dx and the parameter terms differ from the whole chain's
    only by f32 rounding. That case's gradient gap is not here: it is one
    ReLU gate of Fcomb's hidden layer (tests/torch_parity_gaps.py)."""
    from probunet_tpu_torch.ops.kernels import fused_gn as tgn

    h, w, c, groups = chain
    shape = (8, h, w, c)
    x, gamma, beta, scale, shift, seed = _chain(shape, torch.float32, seed=h + c)
    x = x + 2.8 * (torch.arange(c) % 2)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(c))
    consts = (groups, 1e-6, p_drop, True)
    y, mean, rstd = tgn.gn_film_silu_dropout_plain(x, gamma, beta, scale, shift, seed, *consts)
    grads = tgn.gn_film_silu_dropout_bwd_plain(x, g, gamma, beta, scale, shift, seed, mean,
                                               rstd, groups, p_drop, True)
    hb = h // 2
    blocks = [(x[:, i * hb:(i + 1) * hb], g[:, i * hb:(i + 1) * hb],
               tgn.slab_seed(seed, 0, i * hb * w * c)) for i in (0, 1)]
    if p_drop:
        keep = torch.cat([tgn.gn_keep(xb.shape, s, p_drop) for xb, _, s in blocks], dim=1)
        assert torch.equal(keep, tgn.gn_keep(shape, seed, p_drop))

    def over_blocks(run):
        """Each block's outputs, its partial sums summed with the other's."""
        parts = []
        for i in (0, 1):
            run(i, lambda t: parts.append(t.clone()))
        total = parts[0] + parts[1]
        return [run(i, lambda t: t.copy_(total)) for i in (0, 1)]

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    fwd = over_blocks(lambda i, red: tgn.gn_split_fwd(
        blocks[i][0], gamma, beta, scale, shift, blocks[i][2], *consts, h, red, i * hb))
    assert rel(torch.cat([o[0] for o in fwd], dim=1), y) <= SPLIT_STATS_TOL
    for i in (1, 2):
        assert rel(fwd[0][i], (mean, rstd)[i - 1]) <= SPLIT_STATS_TOL
    bwd = over_blocks(lambda i, red: tgn.gn_split_bwd(
        blocks[i][0], blocks[i][1], gamma, beta, scale, shift, blocks[i][2], mean, rstd,
        groups, p_drop, True, h, red, i * hb))
    assert rel(torch.cat([o[0] for o in bwd], dim=1), grads[0]) <= SPLIT_GRADS_TOL
    for i in range(1, 5):
        assert rel(bwd[0][i] + bwd[1][i], grads[i]) <= SPLIT_GRADS_TOL


@pytest.mark.parametrize("shape", [(4, 16, 8, 16), (4, 32, 16, 96)], ids=["16ch", "96ch"])
def test_d_mapping_gives_the_global_rows(shape):
    """D's plain version (and its autograd function) on a block of rows of
    a slab, told the block's first element and the global per-item size:
    the global mask's block bit for bit; with equal per-item sizes the
    unsharded mapping; without the mapping another mask. The other-shape
    hash takes the same mapping."""
    from probunet_tpu_torch.models.layers import other_shape_dropout
    from probunet_tpu_torch.ops.kernels import dropout as tdrop

    b, h, w, c = shape
    item = h * w * c
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    seed = torch.tensor([3, -9], dtype=torch.int32)
    whole = tdrop.dropout(x, seed, 0.2)
    assert torch.equal(tdrop.dropout(x, seed, 0.2, 0, x.numel(), item), whole)
    hb = h // 4
    for b0 in (0, b // 2):
        for h0 in (0, hb, 3 * hb):
            blk = x[b0:b0 + b // 2, h0:h0 + hb].contiguous().requires_grad_(True)
            at = b0 * item + h0 * w * c
            got = tdrop.dropout(blk, seed, 0.2, at, x.numel(), item)
            assert torch.equal(got, whole[b0:b0 + b // 2, h0:h0 + hb]), (b0, h0)
            got.sum().backward()
            assert torch.equal(blk.grad != 0, got != 0)
            other = other_shape_dropout(blk.detach(), seed, 0.2, at, item)
            full = other_shape_dropout(x, seed, 0.2)
            assert torch.equal(other, full[b0:b0 + b // 2, h0:h0 + hb])
    blk = x[:b // 2, hb:2 * hb].contiguous()
    assert not torch.equal(tdrop.dropout(blk, seed, 0.2, hb * w * c, x.numel()),
                           whole[:b // 2, hb:2 * hb])


def _rows(n: int = 2, h: int = 16):
    """A rank's Rows record on a mesh that is never reduced over (no
    process group): enough for the checks made before any collective."""
    from probunet_tpu_torch.parallel.mesh import Mesh
    from probunet_tpu_torch.parallel.spatial import Rows

    mesh = Mesh(shape={"data": 1, "spatial": n}, coords={"data": 0, "spatial": 0}, groups={})
    return Rows(mesh, h0=0, height=n * h)


def test_attention_still_raises_under_a_spatial_mesh():
    """UNetBlock's self-attention, the one option the spatially sharded
    step does not take (no Probabilistic U-Net path enables it), raises
    NotImplementedError naming its ROADMAP item, before any collective."""
    from probunet_tpu_torch.models.layers import UNetBlock

    block = UNetBlock(8, 8, emb_channels=16, attention=True, num_heads=1,
                      generator=torch.Generator().manual_seed(0))
    x = torch.zeros((2, 8, 16, 32)).to(memory_format=torch.channels_last)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 11"):
        block(x, torch.zeros((2, 16)), rows=_rows())


def test_blocks_that_do_not_divide_raise():
    """A block of rows must divide by the pooling factor and by the levels'
    pools: 12 rows at 4x pooling and two levels pass, 6 and 20 / 8 do not;
    for the MS-SSIM ELBO also by its pools between scales: the flagship's
    64 rows pass, 24 do not."""
    from probunet_tpu_torch.parallel.mesh import Mesh, row_sharding
    from probunet_tpu_torch.parallel.spatial import check_block

    check_block(12, 4, 2)
    check_block(64, 16, 4)       # the flagship's block at n_spatial = 2
    check_block(64, 16, 4, msssim_scales=5)
    with pytest.raises(ValueError, match="pooling factor"):
        check_block(6, 4, 2)
    with pytest.raises(ValueError, match="levels"):
        check_block(20, 4, 4)
    with pytest.raises(ValueError, match="MS-SSIM"):
        check_block(24, 4, 2, msssim_scales=5)
    mesh = Mesh(shape={"data": 1, "spatial": 4}, coords={"data": 0, "spatial": 3}, groups={})
    assert row_sharding(mesh, 32) == slice(24, 32)
    with pytest.raises(ValueError, match="divide"):
        row_sharding(mesh, 30)
