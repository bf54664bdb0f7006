"""The CUDA kernels' plain versions against the JAX package's Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as ``tests/test_pallas.py``
runs them; the port's wrappers take their plain PyTorch versions for CPU
tensors. The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.

Tolerance rtol 1e-5 in f32 and bf16 (started at 1e-5 / 1e-4). Reached
on the CPU: f32 3.3e-7 (A) and 2.1e-7 (B) — the same terms summed in
another order; bf16 4.1e-7 (A) — the same operand rounding points (bf16
h0, h1, W1, W2 with f32 sums), where a sum that differs in its last f32
bit can still round a hidden value to the other bf16 neighbour; bf16 B
exactly 0 — the same bf16-rounded differences summed in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close

from probunet_tpu_torch.ops.kernels import afcrps, fcomb_crps

RTOL = {"float32": 1e-5, "bfloat16": 1e-5}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H, W, K, C = 5, 7, 3, 32  # ragged pixel count: 35 is no multiple of any tile


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5, 16])
def test_afcrps_plain_matches_pallas(m, dtype):
    from probunet_tpu.ops.pallas.afcrps import ensemble_crps_terms

    rng = np.random.default_rng(m)
    p = H * W * K
    ens = rng.standard_normal((2, m, p)).astype(np.float32)
    tgt = rng.standard_normal((2, p)).astype(np.float32)
    w1, w2 = ensemble_crps_terms(jnp.asarray(ens, JNP[dtype]), jnp.asarray(tgt, JNP[dtype]))
    before = afcrps.ensemble_crps_terms.launches
    g1, g2 = afcrps.ensemble_crps_terms(torch.from_numpy(ens).to(TORCH[dtype]),
                                        torch.from_numpy(tgt).to(TORCH[dtype]))
    assert afcrps.ensemble_crps_terms.launches == before  # CPU: plain version, no launch
    assert g1.dtype == g2.dtype == torch.float32
    assert_close(g1, np.asarray(w1), RTOL[dtype], what="t1")
    assert_close(g2, np.asarray(w2), RTOL[dtype], what="t2")


def test_afcrps_plain_sorted_form_above_32_members():
    """M > 32 takes the sorted identity; it equals the pairwise sum."""
    from probunet_tpu_torch.ops.losses import _pairwise_abs_sum

    ens = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 64),
                                                                    dtype=np.float32))
    _, t2 = afcrps.ensemble_crps_terms_plain(ens, ens[:, 0])
    assert_close(t2, _pairwise_abs_sum(ens), 1e-5)


def _fcomb_inputs(m, seed):
    rng = np.random.default_rng(seed)
    p = H * W
    return [rng.standard_normal(s).astype(np.float32) for s in
            [(2, C, p), (2, C, m), (C, C), (C,), (C, K), (K,), (2, K, p)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 5, 16])
def test_fcomb_crps_plain_matches_pallas(m, dtype):
    from probunet_tpu.ops.pallas.fcomb_crps import fcomb_crps_terms

    args = _fcomb_inputs(m, seed=10 + m)
    w1, w2 = fcomb_crps_terms(*map(jnp.asarray, args), compute_dtype=dtype)
    before = fcomb_crps.fcomb_crps_terms.launches
    g1, g2 = fcomb_crps.fcomb_crps_terms(*map(torch.from_numpy, args), compute_dtype=dtype)
    assert fcomb_crps.fcomb_crps_terms.launches == before
    assert_close(g1, np.asarray(w1), RTOL[dtype], what="t1")
    assert_close(g2, np.asarray(w2), RTOL[dtype], what="t2")


@pytest.mark.parametrize("loss_type,dtype", [("afcrps", "float32"), ("crps", "float32"),
                                             ("afcrps", "bfloat16")])
def test_fused_fcomb_crps_loss_matches_jax(loss_type, dtype):
    """The whole fused loss, layer-0 projections included, with the Fcomb
    parameters carried from the JAX (1, 1, cin, cout) layout."""
    from probunet_tpu.ops.pallas.fcomb_crps import fused_fcomb_crps_loss as jax_loss

    rng = np.random.default_rng(3)
    d, m = 4, 5
    feats = rng.standard_normal((2, H, W, C)).astype(np.float32)
    zs = rng.standard_normal((m, 2, d)).astype(np.float32)
    tgt = rng.standard_normal((2, H, W, K)).astype(np.float32)
    shapes = {"layer0": (C + d, C), "layer1": (C, C), "layer2": (C, K)}
    jparams = {}
    for name, (cin, cout) in shapes.items():
        jparams[f"{name}_weight"] = (rng.standard_normal((1, 1, cin, cout))
                                     / np.sqrt(cin)).astype(np.float32)
        jparams[f"{name}_bias"] = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    want = jax_loss(jnp.asarray(feats), jnp.asarray(zs),
                    {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(tgt),
                    loss_type, compute_dtype=dtype)
    tparams = {k: torch.from_numpy(v[0, 0] if v.ndim == 4 else v) for k, v in jparams.items()}
    got = fcomb_crps.fused_fcomb_crps_loss(torch.from_numpy(feats), torch.from_numpy(zs),
                                           tparams, torch.from_numpy(tgt), loss_type,
                                           compute_dtype=dtype)
    assert_close(got, float(want), RTOL[dtype], what=loss_type)


def test_wrappers_refuse_non_cpu_tensors_without_the_kernel():
    """A tensor that is not on the CPU never reaches a plain version: a
    device the kernels do not serve raises instead of falling back."""
    ens = torch.empty(2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        afcrps.ensemble_crps_terms(ens, torch.empty(2, 8, device="meta"))
    args = [torch.empty(s, device="meta") for s in
            [(2, C, 8), (2, C, 3), (C, C), (C,), (C, K), (K,), (2, K, 8)]]
    with pytest.raises(ValueError, match="CUDA"):
        fcomb_crps.fcomb_crps_terms(*args)
