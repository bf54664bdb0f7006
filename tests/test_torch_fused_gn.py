"""Kernels C and C′ (the GroupNorm chain), plain versions against the JAX
package's Pallas kernel, and the chain's two routes in ``EDMGroupNorm`` and
``UNetBlock`` against the JAX modules (CPU).

The JAX kernel runs in interpret mode, as ``tests/test_fused_gn.py`` runs
it; the port's wrapper takes its plain PyTorch version for CPU tensors.
The CUDA kernels are compared with these plain versions on the card by
``chip_smoke.py``. Tolerances, as max |error| over max |value| of each
output:

- f32, 1e-5 (reached: 4e-7): the same formula, the statistics and the
  column sums of the backward summed in another order.
- bf16: y and dx 2^-7, one bf16 step at the largest value (reached:
  3.6e-3); mean, rstd and the parameter gradients 2e-3 (reached: 6.1e-4).
  The port rounds x*x to bf16 before the f32 sum, as the TPU kernel's
  ``jnp.sum(x * x, dtype=f32)`` reads; XLA on the CPU keeps that product
  in f32 (excess precision), so rstd moves in its fourth digit and an
  output near a rounding boundary takes the other bf16 neighbour.
- The dropout masks (the zero pattern of y, and of dx where the chain has
  no SiLU) are equal exactly.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import GN_ENV, assert_close

from probunet_tpu_torch.ops.kernels import dropout as tdrop
from probunet_tpu_torch.ops.kernels import fused_gn as tgn

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (H, W, C, groups): tests/test_fused_gn.py's shapes (pack factors 4, 2, 1),
# the decoder's concat width C=96 (k=4, 24 groups) and C=24 (k=16, 6 groups)
SHAPES = [(8, 8, 32, 8), (8, 8, 64, 16), (4, 4, 128, 32), (8, 8, 96, 24), (16, 8, 24, 6)]
# (silu, p_drop): norm1 in training (SiLU, dropout) at every shape; at the
# first shape also norm0 (SiLU, no dropout) and the chain without SiLU,
# with and without dropout
CASES = [(shape, dtype, True, 0.1) for shape in SHAPES for dtype in ("float32", "bfloat16")] + [
    (SHAPES[0], dtype, silu, p_drop) for dtype in ("float32", "bfloat16")
    for silu, p_drop in ((True, 0.0), (False, 0.1), (False, 0.0))]
SEED = np.array([-123456789, 987654321], np.int32)
FWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
STAT_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


def _inputs(h, w, c, seed, b=3):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, h, w, c)) + 0.5).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.2 * rng.standard_normal((b, c))).astype(np.float32),
            (0.2 * rng.standard_normal((b, c))).astype(np.float32),
            rng.standard_normal((b, h, w, c)).astype(np.float32))


def _ratio(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape,dtype,silu,p_drop", CASES)
def test_plain_matches_pallas(shape, dtype, silu, p_drop):
    """Forward (y, mean, rstd) and all five gradients of the plain C/C′
    against the Pallas kernel and its custom_vjp."""
    from probunet_tpu.ops.pallas import fused_gn as jgn

    h, w, c, groups = shape
    x, gamma, beta, scale, shift, g = _inputs(h, w, c, seed=c + h)
    jd = JNP[dtype]

    @jax.jit  # the custom_vjp's own halves: y with the residuals, then the five grads
    def run(x, gamma, beta, scale, shift, g):
        y, res = jgn._vjp_fwd(x, gamma, beta, scale, shift, jnp.asarray(SEED), groups, 1e-5,
                              p_drop, silu)
        grads = jgn._vjp_bwd(groups, 1e-5, p_drop, silu, res, g)[:5]
        return y, res[-2][:, 0], res[-1][:, 0], grads

    want_y, want_mean, want_rstd, want_grads = run(
        jnp.asarray(x, jd), *map(jnp.asarray, (gamma, beta, scale, shift)), jnp.asarray(g, jd))
    targs = [torch.from_numpy(x).to(TORCH[dtype]).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (gamma, beta, scale, shift)]
    before = (tgn.gn_film_silu_dropout.launches, tgn.gn_film_silu_dropout_bwd.launches)
    y = tgn.gn_film_silu_dropout(*targs, torch.from_numpy(SEED), groups, 1e-5, p_drop, silu)
    y.backward(torch.from_numpy(g).to(TORCH[dtype]))
    assert (tgn.gn_film_silu_dropout.launches,
            tgn.gn_film_silu_dropout_bwd.launches) == before  # CPU: plain versions
    _, mean, rstd = tgn.gn_film_silu_dropout_plain(
        *[t.detach() for t in targs], torch.from_numpy(SEED), groups, 1e-5, p_drop, silu)
    assert y.dtype == targs[0].grad.dtype == TORCH[dtype]

    got_y, want_y = y.detach().float().numpy(), np.asarray(want_y, np.float32)
    assert np.array_equal(got_y == 0, want_y == 0), "dropout masks differ"
    if p_drop:
        keep = float((got_y != 0).mean())
        assert abs(keep - (1 - p_drop)) < 5 * (p_drop * (1 - p_drop) / got_y.size) ** 0.5
    assert _ratio(got_y, want_y) <= FWD_TOL[dtype], "y"
    assert _ratio(mean, want_mean) <= STAT_TOL[dtype], "mean"
    assert _ratio(rstd, want_rstd) <= STAT_TOL[dtype], "rstd"
    names = ("dx", "dgamma", "dbeta", "dscale", "dshift")
    for name, t, w_ in zip(names, targs, want_grads):
        w_ = np.asarray(w_, np.float32)
        assert t.grad.shape == w_.shape, name
        tol = FWD_TOL[dtype] if name == "dx" else STAT_TOL[dtype]
        assert _ratio(t.grad.float().numpy(), w_) <= tol, name
    if p_drop and not silu:  # dz = g * mask: dx carries the mask's zeros too
        assert np.array_equal(targs[0].grad.float().numpy() == 0, np.asarray(want_grads[0]) == 0)


@pytest.mark.parametrize("h,w,c", [(8, 8, 32), (16, 8, 24), (4, 4, 128), (2, 4, 96)])
def test_mask_index_is_the_nhwc_index(h, w, c):
    """``_dropout_uniform`` on the lane-packed (HW/k, k*C) block of batch
    element b hashes r*(k*C) + col, which is the NHWC index (h*W + w)*C + c
    of the element: the port's hash of the NHWC index with salt b gives the
    same uniforms bit for bit, with no pack factor."""
    from probunet_tpu.ops.pallas import fused_gn as jgn

    k = jgn._LANE // int(np.gcd(c, jgn._LANE))
    seed = torch.from_numpy(SEED)
    pos = torch.arange(h * w * c, dtype=torch.int64)
    for salt in (0, 1, 7):
        want = jgn._dropout_uniform((h * w // k, k * c), jnp.int32(SEED[0]), jnp.int32(SEED[1]),
                                    jnp.int32(salt))
        got = tdrop.hash_uniform(pos, seed, torch.tensor(salt, dtype=torch.int64))
        assert np.array_equal(got.numpy(), np.asarray(want).reshape(-1)), salt
    keep = tgn.gn_keep((2, h, w, c), seed, 0.3)
    want = jgn._dropout_uniform((h * w // k, k * c), jnp.int32(SEED[0]), jnp.int32(SEED[1]),
                                jnp.int32(1)) >= np.float32(0.3)
    assert np.array_equal(keep[1].numpy(), np.asarray(want).reshape(h, w, c))


def test_supported_matches_jax():
    from probunet_tpu.ops.pallas import fused_gn as jgn

    n = 0
    for h in (1, 2, 4, 6, 8, 12, 16, 32, 128):
        for w in (1, 2, 4, 8, 16, 128):
            for c in (4, 8, 12, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512):
                for groups in {min(32, c // 4), 3, 5}:
                    got = tgn.supported(h, w, c, groups)
                    assert got == jgn.supported(h, w, c, groups), (h, w, c, groups)
                    n += got
    assert n > 100


# ---------------------------------------------------------------------------
# Kernel C′'s per-shape plan (ops/kernels/fused_gn.py:bwd_plan), checked
# here by walking the kernel's own thread mapping: block `rank` of the
# cluster of channel part `part` takes rows [rank * rows, ...) and thread t
# column t % cols, row t / cols of each iteration.
# ---------------------------------------------------------------------------

# chip_smoke.py's GN_CASES: (B, H, W, C), dtype
GN_CASES = [((128, 128, 128, 32), "bfloat16"), ((128, 128, 128, 96), "bfloat16"),
            ((128, 16, 16, 512), "bfloat16"), ((128, 64, 64, 64), "float32")]


@pytest.fixture(scope="module")
def flagship_chains():
    """(H*W, C, groups) of the 57 GroupNorm chains of one forward of the
    flagship U-Net (``probunet_multivar_128``), as forward pre-hooks see
    them."""
    from probunet_tpu_torch.config import preset
    from probunet_tpu_torch.models.layers import EDMGroupNorm
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    cfg = preset("probunet_multivar_128")
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device="cpu")
    chains = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, a: chains.append((a[0].shape[2] * a[0].shape[3], a[0].shape[1], mod.groups)))
        for mod in model.unet.modules() if isinstance(mod, EDMGroupNorm)]
    with torch.no_grad():
        model.unet(torch.zeros(1, *cfg.data.resolution, len(cfg.data.variables)))
    for h in hooks:
        h.remove()
    return chains


def _plan_coverage(hw, c, plan):
    """How often the cluster route visits each (pixel, channel) of one
    batch element (the grid's y dimension is the batch element)."""
    cp, cs, iters = plan["part_channels"], plan["cluster"], plan["iters"]
    cols = cp // 8
    rpi = tgn.CLUSTER_THREADS // cols
    t = np.arange(tgn.CLUSTER_THREADS)
    col, row = t % cols, t // cols
    count = np.zeros((hw, c), np.int32)
    for part in range(c // cp):
        for rank in range(cs):
            r0 = rank * plan["rows"]
            r1 = min(hw, r0 + plan["rows"])
            px = r0 + np.arange(iters)[:, None] * rpi + row[None, :]
            ok = (row < rpi)[None, :] & (px < r1)
            ch = np.broadcast_to(part * cp + col * 8, px.shape)[ok]
            for i in range(8):
                np.add.at(count, (px[ok], ch + i), 1)
    return count


def _check_cluster(hw, c, groups, itemsize, plan, smem_bytes=tgn.cluster_smem_bytes,
                   register_blocks=tgn.BWD_REGISTER_BLOCKS):
    """A cluster layout of C′ (by default: its shared memory, x and dz, and
    its launch bounds' blocks an SM) or of C (``fwd_cluster_smem_bytes``,
    x alone, and ``FWD_REGISTER_BLOCKS``), walked through the kernel's
    thread mapping."""
    assert plan["route"] == "cluster", (hw, c, groups, plan)
    cp, cs = plan["part_channels"], plan["cluster"]
    assert c % cp == 0 and cp % 8 == 0 and cp % (c // groups) == 0, plan  # whole groups
    assert 1 <= cs <= tgn.MAX_CLUSTER == 8 and cp // 8 <= tgn.CLUSTER_THREADS, plan
    assert plan["rows"] == -(-hw // cs)
    smem = smem_bytes(cp, plan["iters"], itemsize)
    assert plan["smem"] == smem <= tgn.SMEM_PER_BLOCK, plan
    # the blocks an SM holds at once: their shared memory and threads fit it
    held = plan["blocks_per_sm"]
    assert held == tgn.blocks_per_sm(smem, register_blocks) >= 1, plan
    assert held * (smem + tgn.SMEM_RESERVED) <= tgn.SMEM_PER_SM, plan
    assert held * tgn.CLUSTER_THREADS <= tgn.THREADS_PER_SM and held <= register_blocks, plan
    # a cluster's slots hold the part's rows
    assert cs * plan["iters"] * tgn.CLUSTER_THREADS * 8 >= hw * cp
    assert (_plan_coverage(hw, c, plan) == 1).all(), plan
    return plan


def _check_plan(hw, c, groups, itemsize):
    return _check_cluster(hw, c, groups, itemsize, tgn.bwd_plan(hw, c, groups, itemsize))


def test_bwd_plan_covers_every_flagship_chain(flagship_chains):
    """Every one of the flagship's 57 chains (bf16, as the training step
    runs them) gets a plan. Each has a cluster layout: each element of a
    batch element once, whole groups per part, at most 8 blocks a
    cluster, blocks that fit two to an SM (112 KB). The plan takes it
    where its rows are 64 bytes or wider; the 13 chains at 128x128 (16-byte
    rows) and the one at 64x64x192 (48-byte rows) take two passes."""
    assert len(flagship_chains) == 57
    routes = {"cluster": 0, "two_pass": 0}
    for hw, c, groups in flagship_chains:
        layout = _check_cluster(hw, c, groups, 2, tgn.cluster_plan(hw, c, groups, 2))
        assert layout["smem"] <= tgn.SMEM_TWO_PER_SM, layout
        plan = tgn.bwd_plan(hw, c, groups, 2)
        routes[plan["route"]] += 1
        wide = layout["part_channels"] * 2 >= 64
        assert plan == (layout if wide else tgn.TWO_PASS), (hw, c, groups, plan)
        assert wide == (hw < 128 * 128 and (hw, c) != (64 * 64, 192)), (hw, c, groups, layout)
    assert routes == {"cluster": 43, "two_pass": 14}


@pytest.mark.parametrize("shape,dtype", GN_CASES, ids=[f"{s[1]}x{s[2]}x{s[3]}-{d}"
                                                       for s, d in GN_CASES])
def test_bwd_plan_covers_the_chip_cases(shape, dtype):
    """chip_smoke.py runs C′ at each case on its plan and on the other
    route: the 16x16x512 bf16 case plans a cluster (the other route is two
    passes); the 128x128 bf16 cases (16-byte rows) and the f32 case plan
    two passes (the other route is the shape's cluster layout)."""
    _, h, w, c = shape
    groups, itemsize = min(32, c // 4), TORCH[dtype].itemsize
    layout = _check_cluster(h * w, c, groups, itemsize, tgn.cluster_plan(h * w, c, groups,
                                                                         itemsize))
    plan = tgn.bwd_plan(h * w, c, groups, itemsize)
    assert plan == (layout if (h, dtype) == (16, "bfloat16") else tgn.TWO_PASS)


def test_bwd_plan_two_pass_where_no_cluster_holds_the_slab():
    """f32 x, C not a multiple of 8, rows narrower than 64 bytes, or more
    rows than 8 blocks hold (a 128x128x32 bf16 slab fits in 8-channel
    parts, 256x256x32 does not)."""
    assert tgn.bwd_plan(64, 64, 16, 4) == tgn.TWO_PASS
    assert tgn.cluster_plan(64, 12, 3, 2) is None
    assert tgn.bwd_plan(64, 12, 3, 2) == tgn.TWO_PASS
    assert tgn.cluster_plan(128 * 128, 32, 8, 2)["part_channels"] == 8
    assert tgn.bwd_plan(128 * 128, 32, 8, 2) == tgn.TWO_PASS
    assert tgn.cluster_plan(256 * 256, 32, 8, 2) is None
    assert tgn.bwd_plan(256 * 256, 32, 8, 2) == tgn.TWO_PASS
    assert tgn.bwd_plan(64 * 64, 32, 8, 2)["route"] == "cluster"


def test_bwd_plan_is_made_once_per_shape():
    """The plan is a function of four ints, cached: a training step's 57
    launches do not search again."""
    assert tgn.bwd_plan(4096, 64, 16, 2) is tgn.bwd_plan(4096, 64, 16, 2)
    assert tgn.cluster_plan(64, 64, 16, 4) is tgn.cluster_plan(64, 64, 16, 4)


# ---------------------------------------------------------------------------
# Kernel C's per-shape plan (ops/kernels/fused_gn.py:fwd_plan). Its cluster
# kernel maps threads as C′'s does (thread t: column t % cols, row t / cols
# of each iteration), so the same walk checks its layouts, with C's shared
# memory (x alone) and its launch bounds (4 blocks an SM by registers).
# ---------------------------------------------------------------------------

def _check_fwd_cluster(hw, c, groups, itemsize, plan):
    _check_cluster(hw, c, groups, itemsize, plan, tgn.fwd_cluster_smem_bytes,
                   tgn.FWD_REGISTER_BLOCKS)
    # what the plan takes a cluster for: rows of a 32-byte sector or more,
    # and three or more blocks an SM
    assert plan["part_channels"] * itemsize >= 32 and plan["blocks_per_sm"] >= 3, plan
    return plan


def test_fwd_plan_covers_every_flagship_chain(flagship_chains):
    """All 57 flagship chains (bf16) take C's cluster route, each layout
    walked through the kernel's thread mapping: every element of a batch
    element once, whole groups per part, shared memory within a block's
    limit and the blocks an SM the plan promises. The 13 chains at 128x128
    take 16-channel parts (32-byte rows) on 8 blocks, 3 an SM; 64x64x192
    48-channel parts, 3 an SM; the other 43 parts of 32 to 64 channels, 4
    an SM."""
    seen = collections.Counter()
    for hw, c, groups in flagship_chains:
        plan = _check_fwd_cluster(hw, c, groups, 2, tgn.fwd_plan(hw, c, groups, 2))
        seen[(plan["part_channels"] * 2 >= 64, plan["blocks_per_sm"])] += 1
        if hw == 128 * 128:
            assert (plan["part_channels"], plan["cluster"]) == (16, 8), plan
    assert seen == {(True, 4): 43, (True, 3): 1, (False, 3): 13}


@pytest.mark.parametrize("shape,dtype", GN_CASES, ids=[f"{s[1]}x{s[2]}x{s[3]}-{d}"
                                                       for s, d in GN_CASES])
def test_fwd_plan_covers_the_chip_cases(shape, dtype):
    """chip_smoke.py runs C at each case on its plan and on the three
    passes: every case plans a cluster layout, 16x16x512 on one block a
    cluster, the others on 8."""
    _, h, w, c = shape
    groups, itemsize = min(32, c // 4), TORCH[dtype].itemsize
    plan = _check_fwd_cluster(h * w, c, groups, itemsize, tgn.fwd_plan(h * w, c, groups,
                                                                      itemsize))
    assert plan["cluster"] == (1 if h == 16 else 8), plan


def test_fwd_plan_three_pass_where_no_cluster_pays():
    """C % 8 != 0 and slabs no cluster holds take the three passes, in f32
    as in bf16; so do layouts the card ran slower than the three passes:
    16-byte rows (a 256x256x32 bf16 slab fits 8 blocks only in 8-channel
    parts) and one block an SM."""
    assert tgn.fwd_plan(64, 12, 3, 2) == tgn.THREE_PASS
    assert tgn.fwd_plan(64, 12, 3, 4) == tgn.THREE_PASS
    assert tgn.fwd_plan(256 * 256, 32, 8, 4) == tgn.THREE_PASS  # f32: no layout fits
    wide = tgn.cluster_layouts(256 * 256, 32, 8, 2, tgn.fwd_cluster_smem_bytes,
                               tgn.FWD_REGISTER_BLOCKS)
    assert wide and all(la["part_channels"] == 8 or la["blocks_per_sm"] < 3 for la in wide)
    assert tgn.fwd_plan(256 * 256, 32, 8, 2) == tgn.THREE_PASS
    assert tgn.fwd_plan(64 * 64, 64, 16, 4)["route"] == "cluster"  # f32 where a cluster pays


def test_fwd_plan_is_made_once_per_shape():
    """The plan is a function of four ints, cached: a forward's 57 launches
    do not search again."""
    assert tgn.fwd_plan(4096, 64, 16, 2) is tgn.fwd_plan(4096, 64, 16, 2)
    assert tgn.fwd_plan(64, 12, 3, 2) is tgn.fwd_plan(64, 12, 3, 2)


def test_wrapper_refuses_tensors_it_cannot_launch_on():
    """A tensor that is not on the CPU never reaches the plain version: a
    device the kernels do not serve raises, and so do CPU tensors mixed
    with others."""
    args = [torch.empty(s, device="meta") for s in [(2, 8, 8, 32), (32,), (32,), (2, 32), (2, 32)]]
    seed = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgn.gn_film_silu_dropout(*args, seed, 8, 1e-5, 0.0, True)
    cpu = [torch.zeros(a.shape) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        tgn.gn_film_silu_dropout(*cpu[:4], args[4], torch.zeros(2, dtype=torch.int32), 8, 1e-5,
                                 0.0, True)


# ---------------------------------------------------------------------------
# The chain's routes in the layers, against the JAX modules: "kernel" under
# PROBUNET_GN_IMPL=pallas, "composed" under the JAX default with
# PROBUNET_DROPOUT_IMPL=pallas. f32, rtol 1e-5 / atol 1e-6 (one layer: the
# statistics summed in another order); the dropout masks equal exactly.
# ---------------------------------------------------------------------------

def _set_env(monkeypatch, gn_impl):
    for k, v in GN_ENV[gn_impl].items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("gn_impl", ["kernel", "composed"])
@pytest.mark.parametrize("h,w,c", [(8, 8, 32), (4, 4, 32)])
def test_edm_group_norm_matches_jax(monkeypatch, gn_impl, h, w, c):
    """The whole chain with FiLM and dropout. (4, 4, 32) is a shape the
    kernel does not take (HW/k = 4 rows): both packages run the composed
    chain there, on either setting."""
    from probunet_tpu.models.layers import EDMGroupNorm as JaxGN

    from probunet_tpu_torch.models.layers import EDMGroupNorm

    _set_env(monkeypatch, gn_impl)
    x, gamma, beta, scale, shift, _ = _inputs(h, w, c, seed=5, b=2)
    groups = min(32, c // 4)
    assert tgn.supported(h, w, c, groups) == ((h, w, c) != (4, 4, 32))
    key = jax.random.key(3)
    seed = np.asarray(jax.random.key_data(key)).ravel()[:2].astype(np.int32)
    jparams = {"gn": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}}
    want = JaxGN().apply({"params": jparams}, jnp.asarray(x), silu=True,
                         film=(jnp.asarray(scale), jnp.asarray(shift)), drop_p=0.1,
                         drop_rng=key)
    mod = EDMGroupNorm(c, gn_impl=gn_impl)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(gamma))
        mod.bias.copy_(torch.from_numpy(beta))
    before = tgn.gn_film_silu_dropout.launches
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    got = mod(xt, silu=True, film=(torch.from_numpy(scale), torch.from_numpy(shift)),
              drop_p=0.1, drop_seed=torch.from_numpy(seed)).permute(0, 2, 3, 1)
    assert tgn.gn_film_silu_dropout.launches == before
    got, want = got.detach().numpy(), np.asarray(want)
    assert np.array_equal(got == 0, want == 0), "dropout masks differ"
    assert_close(got, want, 1e-5, 1e-6, gn_impl)


@pytest.mark.parametrize("gn_impl", ["kernel", "composed"])
def test_unet_block_matches_jax(monkeypatch, gn_impl):
    """A decoder block (skip concat, FiLM, dropout): output and every
    parameter gradient, with the seed words the JAX block hands its
    dropout recorded and given to the port. rtol 1e-4 / atol 1e-5: two
    convs and two chains, forward and back."""
    from probunet_tpu.models.layers import UNetBlock as JaxBlock
    from probunet_tpu.ops.pallas import dropout as jdrop
    from probunet_tpu.ops.pallas import fused_gn as jgn

    from probunet_tpu_torch.convert import convert_params, flax_params
    from probunet_tpu_torch.models.layers import UNetBlock

    _set_env(monkeypatch, gn_impl)
    rng = np.random.default_rng(11)
    b, h, w, cx, cs, cout, emb_c = 2, 8, 8, 16, 8, 16, 32
    x = rng.standard_normal((b, h, w, cx)).astype(np.float32)
    skip = rng.standard_normal((b, h, w, cs)).astype(np.float32)
    emb = rng.standard_normal((b, emb_c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    block = UNetBlock(cx + cs, cout, emb_c, generator=torch.Generator().manual_seed(1),
                      dropout=0.1, gn_impl=gn_impl)
    with torch.no_grad():  # conv1 starts at zero: every parameter gets noise
        for pname, prm in block.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(prm.shape).astype(np.float32))
            if prm.dim() > 1:
                prm.copy_(noise * prm[0].numel() ** -0.5)
            else:
                prm.copy_(0.1 * noise + (1.0 if "norm" in pname and "weight" in pname else 0.0))
    # record the seed words of the block's one dropout (norm1's chain)
    seeds = []
    if gn_impl == "kernel":
        mod, name, p_at, seed_at = jgn, "gn_film_silu_dropout", 8, 5
    else:
        mod, name, p_at, seed_at = jdrop, "dropout", 2, 1
    real = getattr(mod, name)

    def recording(*args):
        if args[p_at] > 0.0:
            seeds.append(args[seed_at])
        return real(*args)

    monkeypatch.setattr(mod, name, recording)
    jblock = JaxBlock(out_channels=cout, dropout=0.1)

    @jax.jit  # one compile: an eager run interprets the Pallas kernel call by call
    def run(p, x, skip, g):
        seeds.clear()
        y, vjp = jax.vjp(lambda *a: jblock.apply(
            {"params": a[0]}, a[1], jnp.asarray(emb), True, a[2],
            rngs={"dropout": jax.random.key(4)}), p, x, skip)
        return y, jnp.stack(seeds), vjp(g)

    want, seed_words, (want_dp, want_dx, want_dskip) = run(
        jax.tree.map(jnp.asarray, flax_params(block)), jnp.asarray(x), jnp.asarray(skip),
        jnp.asarray(g))
    assert seed_words.shape == (1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    st = torch.from_numpy(skip).permute(0, 3, 1, 2).requires_grad_()
    got = block(xt, torch.from_numpy(emb), st, train=True,
                drop_seed=torch.from_numpy(np.array(seed_words[0]))).permute(0, 2, 3, 1)
    got.backward(torch.from_numpy(g))
    assert np.array_equal(got.detach().numpy() == 0, np.asarray(want) == 0)
    assert_close(got.detach(), want, 1e-4, 1e-5, "block output")
    assert_close(xt.grad.permute(0, 2, 3, 1), want_dx, 1e-4, 1e-5, "dx")
    assert_close(st.grad.permute(0, 2, 3, 1), want_dskip, 1e-4, 1e-5, "dskip")
    want_grads = convert_params(jax.device_get(want_dp), block)
    for pname, prm in block.named_parameters():
        assert_close(prm.grad, want_grads[pname], 1e-4, 1e-5, f"d{pname}")
