"""The U-Net's gradient rematerialization in the port (``remat``), on the
tiny model with dropout on (CPU).

- Every mode leaves the training ELBO's loss and every gradient exactly
  as ``remat=False`` leaves them, on both GroupNorm routes: the seed words
  are tensors, so a recompute regenerates the same masks, and the CPU's
  kernels give the same bits when they run again.
- The modes do recompute: the chains of every checkpointed block (all of
  them for ``True`` and the ``save_convs`` modes, those of one level for
  ``(0,)`` and ``(1,)``) run their forward again in the backward.
- ``"save_convs"`` and ``(0,)`` against the JAX model built with the same
  ``remat``, rtol 1e-4 / atol 1e-5 as test_torch_train.py.
- ``from_config`` reads ``tuple(remat_levels) or remat`` as the JAX CLI
  does; an unknown mode raises.
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    TINY,
    assert_close,
    jax_dropout_seeds,
    jax_elbo_grads,
    jax_tiny_model,
    torch_tiny_model,
)

from probunet_tpu_torch.convert import convert_params
from probunet_tpu_torch.ops.kernels import dropout as tdrop
from probunet_tpu_torch.ops.kernels import fused_gn as tgn

DROPOUT, B, M, BETA_1 = 0.1, 2, 4, 0.7
MODES = [True, (0,), (1,), "save_convs", "save_convs_all"]


def _batch():
    rng = np.random.default_rng(21)
    h, w = TINY["img_resolution"]
    x = rng.standard_normal((B, h, w, TINY["input_channels"])).astype(np.float32)
    y = rng.standard_normal((B, h, w, TINY["num_classes"])).astype(np.float32)
    eps = rng.standard_normal((M, B, TINY["latent_dim"])).astype(np.float32)
    return x, y, eps


@pytest.fixture(scope="module")
def params():
    return jax_tiny_model(dropout=DROPOUT)[1]


def _count_chains(monkeypatch) -> list:
    """A list that grows by one at each GroupNorm chain forward that drops
    or runs kernel C: the plain versions of C and of D's mask."""
    calls = []
    for mod, name in ((tgn, "gn_film_silu_dropout_plain"), (tdrop, "dropout_keep")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, **k: calls.append(1)
                            or _real(*a, **k))
    return calls


def _run(model, seeds):
    """(loss, gradients by name) of one training ELBO and its backward."""
    x, y, eps = _batch()
    model.zero_grad()
    total, _ = model.elbo(torch.from_numpy(x), torch.from_numpy(y), M=M, beta_1=BETA_1,
                          eps=torch.from_numpy(eps), training=True, seeds=seeds)
    total.backward()
    return total.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _seeds(model):
    return torch.from_numpy(np.random.default_rng(22).integers(
        -2 ** 31, 2 ** 31, (len(model.unet.dropout_blocks), 2), dtype=np.int32))


@pytest.fixture(scope="module")
def reference(params):
    """Per route, remat=False's loss, gradients, chain count and the
    chains counted in each block's forward."""
    out = {}
    for gn_impl in ("kernel", "composed"):
        model = torch_tiny_model(params, dropout=DROPOUT, gn_impl=gn_impl)
        per_block = {}
        with pytest.MonkeyPatch.context() as mp:
            calls = _count_chains(mp)
            for name in model.unet.dropout_blocks:
                block = model.unet.get_submodule(name)
                block.register_forward_pre_hook(
                    lambda m, a, n=name: per_block.__setitem__(n, -len(calls)))
                block.register_forward_hook(
                    lambda m, a, o, n=name: per_block.__setitem__(n, per_block[n] + len(calls)))
            total, grads = _run(model, _seeds(model))
        out[gn_impl] = total, grads, len(calls), per_block
    return out


@pytest.mark.parametrize("gn_impl", ["kernel", "composed"])
@pytest.mark.parametrize("mode", MODES, ids=str)
def test_remat_leaves_loss_and_gradients_unchanged(params, reference, monkeypatch, mode,
                                                   gn_impl):
    model = torch_tiny_model(params, dropout=DROPOUT, gn_impl=gn_impl, remat=mode)
    calls = _count_chains(monkeypatch)
    total, grads = _run(model, _seeds(model))
    want_total, want_grads, base_calls, per_block = reference[gn_impl]
    assert torch.equal(total, want_total)
    for name, g in grads.items():
        assert torch.equal(g, want_grads[name]), name
    # each checkpointed block runs its chains once more in the backward
    remat_blocks = [n for n, how in model.unet.block_remat.items() if how]
    assert 0 < len(remat_blocks) <= len(model.unet.dropout_blocks)
    assert len(calls) - base_calls == sum(per_block[n] for n in remat_blocks) > 0


@pytest.mark.parametrize("remat", ["save_convs", (0,)], ids=str)
def test_remat_matches_jax(params, monkeypatch, remat):
    """On the composed route: the kernel route is held to the JAX package
    without remat in test_torch_train.py and to itself under every mode
    above, and the JAX program with the Pallas chain under remat takes
    twice as long to compile."""
    gn_impl = "composed"
    from probunet_tpu.models.prob_unet import ProbabilisticUNet as JaxModel

    jmodel = JaxModel(**TINY, dropout=DROPOUT, remat=remat)
    x, y, eps = _batch()
    seeds = jax_dropout_seeds(monkeypatch, jmodel, params, x)
    want_total, _, want_grads, _ = jax_elbo_grads(
        monkeypatch, jmodel, params, x, y, eps, "afcrps", True, BETA_1, M, gn_impl, record=False)
    model = torch_tiny_model(params, dropout=DROPOUT, gn_impl=gn_impl, remat=remat)
    assert seeds.shape == (len(model.unet.dropout_blocks), 2)
    total, grads = _run(model, torch.from_numpy(seeds))
    assert_close(total, want_total, 1e-4, 1e-5, "loss")
    want = convert_params(want_grads, model)
    for name, g in grads.items():
        assert_close(g, want[name], 1e-4, 1e-5, f"d{name}")


def _cfg(remat, remat_levels):
    from probunet_tpu_torch.config import preset

    cfg = preset("probunet_multivar_128")
    m = cfg.model
    m.latent_dim, m.num_filters, m.model_channels = (TINY["latent_dim"], TINY["num_filters"],
                                                     TINY["model_channels"])
    m.channel_mult, m.num_blocks = TINY["channel_mult"], TINY["num_blocks"]
    cfg.data.resolution = TINY["img_resolution"]
    cfg.train.remat, cfg.train.remat_levels = remat, remat_levels
    return cfg


@pytest.mark.parametrize("remat,levels", [(True, (1,)), (True, ()), ("save_convs", ()),
                                          ("save_convs_all", ()), (False, ())], ids=str)
def test_from_config_reads_remat_levels_over_remat(remat, levels):
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    model = ProbabilisticUNet.from_config(_cfg(remat, levels), torch.Generator().manual_seed(0),
                                          device="cpu", gn_impl="composed")

    def want(name):
        if levels:  # level 1 of the tiny U-Net is its 8x8 level
            return "full" if "_8x8_" in name else None
        if remat is True:
            return "full"
        return "save_convs" if remat else None

    assert model.unet.block_remat == {name: want(name) for name in model.unet.dropout_blocks}
    assert model.prior.save_convs == model.posterior.save_convs == (remat == "save_convs_all")
    assert model.unet.out_norm.gn_impl == "composed"


@pytest.mark.parametrize("bad", ["everything", "save_conv", 1, (0.5,), (True,)], ids=str)
def test_unknown_remat_mode_raises(bad):
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    with pytest.raises(ValueError, match="remat"):
        ProbabilisticUNet(generator=torch.Generator().manual_seed(0), **TINY, remat=bad)
    with pytest.raises(ValueError, match="gn_impl"):
        ProbabilisticUNet(generator=torch.Generator().manual_seed(0), **TINY, gn_impl="xla")
