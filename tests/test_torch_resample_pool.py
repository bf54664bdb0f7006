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
plain version bit for bit; here, the wrapper's shape checks.
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


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8, 16])
def test_avg_pool_is_the_jax_packages_bit_for_bit(k):
    from probunet_tpu.ops.resample import avg_pool as jax_avg_pool

    rng = np.random.default_rng(k)
    x = _six_decades(rng, (2, 3, 2 * k, 3 * k, 3))
    want = np.asarray(jax_avg_pool(jnp.asarray(x), k))
    got = avg_pool(torch.from_numpy(x), k)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    # the reshape-mean the port pooled with before adds in another order
    mean = torch.from_numpy(x).reshape(2, 3, 2, k, 3, k, 3).mean(dim=(-4, -2))
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
