"""Pooling at the JAX package's rounding points, bit for bit on the CPU.

- ``ops.resample.avg_pool`` (the plain version of kernel G,
  ``ops/kernels/avg_pool.py``) against ``probunet_tpu.ops.resample.avg_pool``
  at k = 2, 3, 4, 5, 8 and 16, f32, with leading batch axes and values
  spread over six decades. XLA adds each window's terms in row-major order
  and multiplies by f32(1 / k^2); ``Tensor.mean`` over the window axes, the
  port's pooling before, adds in another order and differs in the last bit.
- The MS-SSIM levels' padded 2x2 pool (``ops.msssim._avg_pool2_padded``)
  against the JAX package's ``lax.reduce_window`` at even and odd sides, f32
  and bf16: XLA adds a window's four terms in x's type, row by row, or
  column by column where W is odd.

Kernel G runs only on the card, where ``chip_smoke.py`` holds it to the
plain version bit for bit on each of its routes; here, the wrapper's shape checks
and the plan the wrapper launches it with, at every pooling shape a
preset reaches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.ops.kernels import avg_pool as g
from probunet_tpu_torch.ops.resample import avg_pool

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _six_decades(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)


# (k, shape): k = 2-16 on leading batch axes; the 64x64 presets' batch
# pooled by 8; a stats-like stack of more items than a batch holds
POOLS = [*((k, (2, 3, 2 * k, 3 * k, 3)) for k in (2, 3, 4, 5, 8, 16)),
         (8, (8, 64, 64, 1)), (16, (40, 32, 32, 3))]
POOL_IDS = ["2", "3", "4", "5", "8", "16", "8-presets64", "16-stack40"]


@pytest.mark.parametrize(("k", "shape"), POOLS, ids=POOL_IDS)
def test_avg_pool_is_the_jax_packages_bit_for_bit(k, shape):
    from probunet_tpu.ops.resample import avg_pool as jax_avg_pool

    rng = np.random.default_rng(k + len(shape))
    x = _six_decades(rng, shape)
    want = np.asarray(jax_avg_pool(jnp.asarray(x), k))
    got = avg_pool(torch.from_numpy(x), k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # the reshape-mean the port pooled with before adds in another order
    *lead, h, w, c = shape
    mean = torch.from_numpy(x).reshape(*lead, h // k, k, w // k, k, c).mean(dim=(-4, -2))
    if k > 2:
        assert not np.array_equal(mean.numpy(), want)


def test_window_mean_checks_its_shape():
    x = torch.zeros(2, 12, 8, 3)
    assert avg_pool(x, 1) is x
    with pytest.raises(ValueError, match="not divisible"):
        avg_pool(x, 3)
    with pytest.raises(ValueError, match=r"\(\.\.\., H, W, C\)"):
        g.window_mean(torch.zeros(4, 4), 2)
    assert g.inverse_area(3) == np.float32(1.0 / 9.0)


def _pooling_shapes() -> list[tuple[int, int, int, int, int]]:
    """(items, H, W, C, k) of every pooling a preset reaches: each batch the
    CLIs and bench take, each split's stack for compute_stats, the
    full-domain stack padded to a multiple of k and its tiles, and the
    blocks of rows of a 1 x 2 and a 1 x 4 spatial mesh."""
    from probunet_tpu_torch.config import PRESETS, preset

    out = set()
    for name in PRESETS:
        d = preset(name).data
        (h, w), k, c = d.resolution, d.lowres_scale, len(d.variables)
        for bs in (1, 8, 16, 32, 128, 512):
            out.add((bs, h, w, c, k))
            for parts in (2, 4):
                out.add((bs, h // parts, w, c, k))
        for years in (d.years_train, d.years_val, d.years_test, (2001, 2002)):
            days = 365 * (years[1] - years[0])
            out.add((days, h, w, c, k))
            if name == "fulldomain_dp8":
                side = -(-d.coords[1] // k) * k
                out.add((days, side, side, c, k))
    return sorted(out)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_g_plans_stay_within_the_cards_limits(aligned):
    """Kernel G's plan at every pooling shape a preset reaches, and at a
    wide C and an odd k: at most 227 KB of shared memory and 1,024 (the
    kernels' bound: 256) threads a block, a grid of 1 to 2^31 - 1 blocks,
    and a "ring" tile that divides the output rows and columns, one thread
    a chain, its slots whole 16-byte copies. The presets' poolings take
    the ring where x is aligned, but for (k, C) = (8, 1), which takes
    "direct"; where x is not, "channels"."""
    shapes = _pooling_shapes()
    assert len(shapes) >= 40
    for items, h, w, c, k in [*shapes, (8, 32, 32, 64, 16), (8, 96, 96, 3, 3),
                              (2, 16 * 70, 16 * 70, 31, 16), (1, 4096, 4096, 17, 16)]:
        pl = g.plan(items, h, w, c, k, aligned)
        assert pl.smem <= 227 * 1024 and 32 <= pl.threads <= min(1024, g.THREADS_MAX)
        assert pl.threads % 32 == 0 and 1 <= pl.grid < 2 ** 31, pl
        assert pl.k_inst == (k if k in (8, 16) else 0)
        if (items, h, w, c, k) in shapes:
            route = ("channels" if not aligned else
                     "direct" if (k, c) == (8, 1) else "ring")
            assert pl.route == route, (items, h, w, c, k, pl)
        if pl.route == "ring":
            rows_out, wo = items * (h // k), w // k
            assert aligned and w * c % 4 == 0 and k * c % 4 == 0
            assert rows_out % pl.rows == 0 and wo % pl.cols == 0 and pl.threads >= (
                pl.rows * pl.cols * c)
            assert pl.rows == 1 or pl.cols == wo
            assert pl.col_stride >= k * c and pl.row_stride >= pl.cols * pl.col_stride
            assert pl.smem == pl.stages * pl.rows * pl.row_stride * 4 and 2 <= pl.stages <= 3
            assert pl.col_stride % 4 == 0 and pl.row_stride % 4 == 0
            assert pl.grid <= rows_out // pl.rows * (wo // pl.cols)
        else:
            assert pl.route in ("channels", "direct") and pl.smem == 0
    # the flagship's batch: one warp a tile of one output row, its columns
    # apart by 52 floats, so the warp's 24 reads hit 24 banks
    pl = g.plan(128, 128, 128, 3, 16)
    assert (pl.route, pl.rows, pl.cols, pl.col_stride, pl.threads) == ("ring", 1, 8, 52, 32)
    assert g._conflicts(1, 8, 3, 52, pl.row_stride, 24) == 1


def test_g_takes_a_wide_c_and_raises_on_what_it_does_not_take():
    """C >= 32 takes the "channels" route, and so do a window row the ring
    cannot hold, a window row that is no whole 16-byte copies (k = 3, C =
    3) and an x off 16 bytes; "direct" takes (k, C) = (8, 1) on 16 bytes
    only; a shape that does not divide, a k below 1 or an empty field
    raises, as do a dtype other than f32 and a non-contiguous x at the
    wrapper, before any launch."""
    assert g.plan(8, 32, 32, 64, 16).route == "channels"
    assert g.plan(1, 1024, 1024, 31, 1024).route == "channels"
    assert g.plan(8, 96, 96, 3, 3).route == "channels"
    assert g.plan(128, 128, 128, 3, 16, aligned=False).route == "channels"
    assert g.plan(8, 64, 64, 1, 8).route == "direct"
    assert g.plan(8, 64, 64, 1, 8, aligned=False).route == "channels"
    assert g.plan(8, 64, 64, 2, 8).route == "ring"
    for shape in [(2, 12, 8, 3, 3), (2, 8, 12, 3, 16), (2, 8, 8, 3, 0), (0, 8, 8, 3, 2),
                  (2, 8, 8, 0, 2)]:
        with pytest.raises(ValueError, match="G takes no pooling"):
            g.plan(*shape)
    with pytest.raises(ValueError, match="takes f32"):
        g._launch(torch.zeros(2, 8, 8, 3, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="not row-major contiguous"):
        g._launch(torch.zeros(2, 8, 8, 3).transpose(1, 2), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 9, 8, 3), (2, 8, 9, 3), (2, 7, 9, 3),
                                   (1, 25, 25, 1)])
def test_msssim_level_pool_is_the_jax_packages_bit_for_bit(shape, dtype):
    from probunet_tpu.ops.msssim import _avg_pool2_padded as jax_pool

    from probunet_tpu_torch.ops.msssim import _avg_pool2_padded

    x = _six_decades(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jax_pool(jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    got = _avg_pool2_padded(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.float().numpy(), want)
