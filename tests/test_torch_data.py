"""Port data path against the JAX package: synthetic fields, transforms,
resampling, statistics, the four preprocessing pipelines and the inversion
back to HR fields.

f32, rtol 1e-6 (atol 1e-6 where a value can sit at 0): the same
elementwise formulas; means and ddof=1 stds reduce in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from probunet_tpu_torch.data import climex as tclimex
from probunet_tpu_torch.data import transforms as ttransforms
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
from probunet_tpu_torch.ops import resample as tresample

RTOL, ATOL = 1e-6, 1e-6
VARS = ("pr", "tasmin", "tasmax")


@pytest.fixture(scope="module")
def fields():
    """(T, H, W, C) physical and storage-space fields. At 16x16 the smooth
    synthetic fields are nearly constant per item (the diurnal range has a
    16-pixel correlation length), which makes a per-item std pure f32
    cancellation noise; pixel noise on the storage fields keeps the
    "pertimestep" statistics well conditioned."""
    from probunet_tpu.data.transforms import apply_physical_transform

    phys = synthetic_climex_fields(8, 16, 16, VARS, seed=3)
    stored = np.asarray(apply_physical_transform(jnp.asarray(phys), VARS))
    noise = np.random.default_rng(3).standard_normal(stored.shape).astype(np.float32)
    return phys, stored + 0.5 * noise


@pytest.mark.parametrize("variables", [VARS, ("pr",), ("tasmax", "pr")])
def test_synthetic_fields_bit_identical(variables):
    from probunet_tpu.data.synthetic import synthetic_climex_fields as jax_fields

    got = synthetic_climex_fields(5, 16, 24, variables, seed=11)
    want = jax_fields(5, 16, 24, variables, seed=11)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_transforms_match(fields):
    from probunet_tpu.data import transforms as jt

    phys = fields[0]
    x = np.linspace(-30.0, 30.0, 241, dtype=np.float32)  # both sides of the threshold
    assert_close(ttransforms.softplus(torch.from_numpy(x)), jt.softplus(jnp.asarray(x)),
                 RTOL, ATOL, "softplus")
    xp = np.abs(x) + 1e-3
    assert_close(ttransforms.softplus_inv(torch.from_numpy(xp)),
                 jt.softplus_inv(jnp.asarray(xp)), RTOL, ATOL, "softplus_inv")
    got = ttransforms.apply_physical_transform(torch.from_numpy(phys), VARS)
    stored = jt.apply_physical_transform(jnp.asarray(phys), VARS)
    assert_close(got, stored, RTOL, ATOL, "apply_physical_transform")
    back = ttransforms.invert_physical_transform(got, VARS)
    assert_close(back, jt.invert_physical_transform(stored, VARS), RTOL, ATOL,
                 "invert_physical_transform")
    assert_close(back, phys, 1e-5, 1e-5, "round trip to physical units")


@pytest.mark.parametrize("op,k", [("avg_pool", 4), ("upsample_nearest", 2),
                                  ("upsample_bilinear", 4), ("repeat_interleave_2d", 2)])
def test_resample_matches(fields, op, k):
    from probunet_tpu.ops import resample as jr

    x = np.ascontiguousarray(fields[1][:3, :8, :8])
    got = getattr(tresample, op)(torch.from_numpy(x), k)
    want = getattr(jr, op)(jnp.asarray(x), k)
    assert tuple(got.shape) == want.shape
    assert_close(got, want, RTOL, ATOL, op)


def _jax_stats_and_port(stored, k=4):
    from probunet_tpu.data.climex import compute_stats

    want = compute_stats(jnp.asarray(stored), k)
    got = tclimex.compute_stats(torch.from_numpy(stored), k)
    return want, got


def test_compute_stats_match(fields):
    want, got = _jax_stats_and_port(fields[1])
    for name in tclimex.Standardization._fields:
        assert_close(getattr(got, name), getattr(want, name), RTOL, ATOL, name)


@pytest.mark.parametrize("pipeline,standardization",
                         [(p, "perpixel") for p in tclimex.PIPELINE_TYPES]
                         + [("lrinterp_to_residuals", s) for s in ("none", "pertimestep",
                                                                   "minmax")])
def test_preprocess_and_residual_to_hr_match(fields, pipeline, standardization):
    """preprocess_batch's every output, then residual_to_hr of the targets,
    which must give back the HR field."""
    from probunet_tpu.data import climex as jc

    stored = fields[1]
    want_stats, got_stats = _jax_stats_and_port(stored)
    hr = stored[:4]
    args = (pipeline, 4, "nearest", 1e-10, standardization)
    want = jc.preprocess_batch(jnp.asarray(hr), want_stats, *args)
    got = tclimex.preprocess_batch(torch.from_numpy(hr), got_stats, *args)
    assert set(got) == set(want)
    for key in ("inputs", "targets", "hr", "lr", "lrinterp"):
        if key in want:
            assert_close(got[key], want[key], 1e-5, 1e-5, key)
    lri_w = jc.lrinterp_from_batch(want, 4)
    lri_g = tclimex.lrinterp_from_batch(got, 4)
    assert_close(lri_g, lri_w, RTOL, ATOL, "lrinterp_from_batch")
    item = got.get("stand_stats")
    hr_g = tclimex.residual_to_hr(got["targets"], lri_g, got_stats, pipeline, 1e-10,
                                  standardization, item)
    hr_w = jc.residual_to_hr(want["targets"], lri_w, want_stats, pipeline, 1e-10,
                             standardization, want.get("stand_stats"))
    assert_close(hr_g, hr_w, 1e-5, 1e-5, "residual_to_hr")
    assert_close(hr_g, hr, 1e-4, 1e-4, "round trip to the HR field")
