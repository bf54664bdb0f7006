"""The spatially sharded step of the port on two gloo ranks spawned on the
CPU (``tests/torch_mp.py``, one spawn for the file): a ("data" = 1,
"spatial" = 2) mesh splits each 32x32 image's rows into two blocks of 16.
Held against the JAX package's one-device train step, against the port's
one-process steps, and its collectives against unsharded autograd.

Tolerances:
- the train step against JAX's (dropout 0, the same posterior noise, one
  AdamW step): loss, recon, kl_mean and grad_norm rtol 1e-4, the
  parameters rtol 2e-3 / atol 2e-5 (JAX ``tests/test_parallel.py:83``);
- against the port's one-process step on the whole batch (dropout 0.1 on
  either GroupNorm route, the eval step, ``remat=True`` and
  ``"save_convs_all"``, Fcomb width 32 on kernel A's route, int8 saved
  convolution inputs), one step at a time from one shared state, as JAX
  ``tests/test_parallel.py:83`` holds one step: step 0 from the shared
  initial state, step 1 from the one-process step's state after step 0
  (its parameters, AdamW moments and count). At each step the metrics
  rtol 1e-5, and the gradients AdamW receives within GRAD_RTOL of the
  largest gradient (C′'s parameter terms, the composed chain's sums and
  the CRPS terms add the blocks' partial sums in another order than the
  whole image's, nothing else; the split plain C/C′ and the encoders'
  mean gather the image and are exact). Two trajectories that each took step
  1 from their own state would part where Adam's first update moves a
  weight whose gradient lies at rounding level, and with it a ReLU gate
  of Fcomb's hidden layer. The masks are the global elements' bit for bit
  (``test_torch_parallel_spatial_mesh.py`` holds the keep masks);
  a wrong mask moves the gradients far beyond these limits;
- the halo exchange and the sum over the axis, values and gradients,
  against unsharded autograd: bit for bit (additions of two terms);
- the partitioned CRPS terms against ``afcrps_loss_pairwise`` /
  ``crps_loss_pairwise``: value and gradients rtol 1e-5, atol 1e-6 (JAX
  ``tests/test_parallel.py:225``).
"""

import numpy as np
import pytest
import torch

from torch_mp import spawn
from torch_parity import assert_close
from torch_parity import torch_one_thread  # noqa: F401  (fixture)
from torch_spatial import (
    B,
    DROPOUT,
    M,
    RES,
    assert_grads_close,
    assert_metrics_close,
    assert_ranks_agree,
    hr_fields,
    jax_train_step,
    one_process,
    params,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

LOSS_RTOL = 1e-4
JAX_PARAM_RTOL, JAX_PARAM_ATOL = 2e-3, 2e-5
RTOL = 1e-5
GRAD_RTOL = (1e-5, 1e-5)
CRPS_RTOL, CRPS_ATOL = 1e-5, 1e-6
N = 2
WIDE = (32, 16)   # Fcomb width 32: the fused ELBO takes kernel A's route


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    h = RES // N
    return {"hr": hr_fields(21), "eps": rng.standard_normal((M, B, 4)).astype(np.float32),
            "x": rng.standard_normal((2, RES, 8, 3)).astype(np.float32),
            "w1": rng.standard_normal((2, N * (h + 2), 8, 3)).astype(np.float32),
            "w2": rng.standard_normal((2, N * (h + 4), 8, 3)).astype(np.float32),
            "ws": rng.standard_normal((N, 2, h, 8, 3)).astype(np.float32),
            "ens": rng.standard_normal((4, 5, RES, 8, 2)).astype(np.float32),
            "tgt": rng.standard_normal((4, RES, 8, 2)).astype(np.float32)}


def _cases(inputs):
    hr, mesh = inputs["hr"], dict(n_data=1, n_spatial=N)
    base = dict(hr=hr, m=M, fused=True, eps=None, steps=2, **mesh)
    return [dict(base, name="jax", dropout=0.0, gn_impl="composed", eps=inputs["eps"],
                 steps=1),
            dict(base, name="dropout kernel", dropout=DROPOUT, gn_impl="kernel"),
            dict(base, name="dropout composed", dropout=DROPOUT, gn_impl="composed",
                 fused=False),
            dict(base, name="eval", dropout=DROPOUT, gn_impl="kernel", eval=True),
            dict(base, name="remat", dropout=DROPOUT, gn_impl="kernel", remat=True, steps=1),
            dict(base, name="remat save_convs_all", dropout=DROPOUT, gn_impl="composed",
                 remat="save_convs_all", steps=1),
            dict(base, name="kernel A", dropout=DROPOUT, gn_impl="kernel", num_filters=WIDE,
                 params=params(WIDE)),
            dict(base, name="act_compress", dropout=DROPOUT, gn_impl="kernel",
                 act_compress=True)]


SINGLE = ("dropout kernel", "dropout composed", "eval", "remat", "remat save_convs_all",
          "kernel A", "act_compress")


@pytest.fixture(scope="module")
def singles(inputs, torch_one_thread):  # noqa: F811
    """The one-process steps of the cases held to them: (metrics, gradients,
    the train state before each step)."""
    out = {}
    for name in SINGLE:
        states = []
        mets, grads, _ = one_process(_case(inputs, name), states=states)
        out[name] = (mets, grads, states)
    return out


@pytest.fixture(scope="module")
def runs(inputs, singles, tmp_path_factory):
    """Each job's outputs by rank, from one spawn of two gloo ranks. A case
    held to the one-process step starts each step after the first from
    the one-process step's state there."""
    wd = tmp_path_factory.mktemp("parallel_spatial_steps")
    cases = _cases(inputs)
    for case in cases:
        states = singles[case["name"]][2] if case["name"] in singles else []
        if len(states) > 1:
            case["starts"] = [None, *states[1:]]
    torch.save({"params": params(), "cases": cases}, wd / "spatial_step.in.pt")
    torch.save({k: inputs[k] for k in ("x", "w1", "w2", "ws", "ens", "tgt")},
               wd / "spatial_ops.in.pt")
    jobs = ("spatial_step", "spatial_ops")
    spawn(list(jobs), wd, world=N, timeout=300)
    return {job: [torch.load(wd / f"{job}.rank{r}.pt", weights_only=False) for r in range(N)]
            for job in jobs}


def _case(inputs, name):
    return next(c for c in _cases(inputs) if c["name"] == name)


def test_spatial_step_matches_jax(inputs, runs, monkeypatch):
    """make_parallel_train_step on a 1 x 2 ("data", "spatial") mesh against
    JAX's make_train_step on one device: dropout 0, the same posterior
    noise, one AdamW step."""
    assert_ranks_agree([r["jax"] for r in runs["spatial_step"]])
    got = runs["spatial_step"][0]["jax"]
    met, want = jax_train_step(monkeypatch, inputs["hr"], inputs["eps"])
    assert_metrics_close(got["metrics"][0], met, LOSS_RTOL, "1x2 vs JAX")
    for k, v in want.items():
        assert_close(got["params"][k], v, JAX_PARAM_RTOL, JAX_PARAM_ATOL, k)


@pytest.mark.parametrize("name", ["dropout kernel", "dropout composed", "remat",
                                  "remat save_convs_all", "kernel A", "act_compress"])
def test_spatial_step_matches_single_process(inputs, runs, singles, name):
    """Dropout 0.1 on either GroupNorm route (split kernels C/C′ under seed
    words shifted to the block's first element; the composed chain with its
    sums summed over the ranks and kernel D's block mapping), under
    ``remat=True`` (the collectives rerun in the backward on both ranks),
    under ``remat="save_convs_all"`` (selective checkpointing of the U-Net
    and the encoders, the collectives among the recomputed operations),
    with Fcomb width 32 (kernel A's terms summed over the ranks), and with
    int8 saved convolution inputs (each halo-padded block's absmax taken
    over both ranks): each step that of the one-process step on the whole
    batch from the same state."""
    outs = [r[name] for r in runs["spatial_step"]]
    assert_ranks_agree(outs)
    mets, grads, _ = singles[name]
    assert len(outs[0]["metrics"]) == len(mets) == _case(inputs, name)["steps"]
    for i, met in enumerate(mets):
        assert_metrics_close(outs[0]["metrics"][i], met, RTOL, f"{name} step {i}")
        assert_grads_close(outs[0]["grads"][i], grads[i], GRAD_RTOL[i], f"{name} step {i}")
    # the masks matter: the step differs from the one without dropout
    nodrop = runs["spatial_step"][0]["jax"]["metrics"][0]["loss"]
    assert abs(float(outs[0]["metrics"][0]["loss"]) - float(nodrop)) > 1e-4


def test_spatial_eval_step_matches_single_process(runs, singles):
    """make_parallel_eval_step on the 1 x 2 mesh: the one-process eval
    step's recon, kl_mean and loss."""
    outs = [r["eval"] for r in runs["spatial_step"]]
    assert_ranks_agree(outs)
    mets, _, _ = singles["eval"]
    assert_metrics_close(outs[0]["metrics"][0], mets[0], RTOL, "eval",
                         names=("recon", "kl_mean", "loss"))


def _padded(x: torch.Tensor, halo: int, n: int) -> list[torch.Tensor]:
    """Each block of rows of x with its halo rows, zeros at the edges."""
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, halo, halo))
    h = x.shape[1] // n
    return [pad[:, i * h:(i + 1) * h + 2 * halo] for i in range(n)]


@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange_and_its_backward_match_unsharded_autograd(inputs, runs, halo):
    """Each rank's padded block is the unsharded image's rows with zero
    rows at its edges, and the gradient of the ranks' summed losses is the
    unsharded autograd gradient: a halo row's gradient reaches the rank
    that owns the row."""
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    w = torch.from_numpy(inputs[f"w{halo}"])
    blocks = _padded(x, halo, N)
    sum(torch.sum(b * wb) for b, wb in zip(blocks, w.chunk(N, dim=1))).backward()
    for r, out in enumerate(runs["spatial_ops"]):
        got = out[f"halo{halo}"]
        assert torch.equal(got["y"], torch.cat([b.detach() for b in blocks], dim=1)), r
        assert torch.equal(got["grad"], x.grad), r


def test_sum_over_and_its_backward_match_unsharded_autograd(inputs, runs):
    """sum_over gives every rank the sum of the blocks; the backward sums
    the ranks' incoming gradients (each rank's loss weights the sum its own
    way)."""
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    blocks = x.chunk(N, dim=1)
    total = sum(blocks)
    ws = torch.from_numpy(inputs["ws"])
    sum(torch.sum(total * ws[r]) for r in range(N)).backward()
    for r, out in enumerate(runs["spatial_ops"]):
        assert torch.equal(out["sum"]["y"], total.detach()), r
        assert torch.equal(out["sum"]["grad"], x.grad), r


@pytest.mark.parametrize("inputs_", ["one", "two"])
def test_int8_convolution_of_halo_padded_blocks_is_exact(inputs, runs, inputs_):
    """EDMConv's int8 route under ``rows``: kernel E (its plain version) SAME
    on each halo-padded block, the outer rows cropped, is the whole image's
    int8 convolution bit for bit (E pads with zeros only where the halo is
    zeros too), with one input and with two."""
    from torch_mp_worker import int8_convs

    conv = int8_convs()[inputs_]
    x = torch.from_numpy(inputs["x"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = conv(x, x * -0.5 if inputs_ == "two" else None).permute(0, 2, 3, 1)
    for r, out in enumerate(runs["spatial_ops"]):
        assert torch.equal(out[f"int8 {inputs_}"], want), r


@pytest.mark.parametrize("loss", ["afcrps", "crps"])
def test_partitioned_crps_terms_match_pairwise(inputs, runs, loss):
    """afcrps_loss / crps_loss with ``rows``: each rank's terms of its rows
    (kernel B's plain version), summed over the ranks and over the global
    pixel count; the value and the gradients (the mean over the axis of
    each rank's gradient of the replicated loss) against the O(M^2)
    oracles (JAX ``tests/test_parallel.py:225``)."""
    from probunet_tpu_torch.ops.losses import afcrps_loss_pairwise, crps_loss_pairwise

    oracle = afcrps_loss_pairwise if loss == "afcrps" else crps_loss_pairwise
    ens = torch.from_numpy(inputs["ens"]).double().requires_grad_(True)
    tgt = torch.from_numpy(inputs["tgt"]).double().requires_grad_(True)
    v = oracle(ens, tgt)
    v.backward()
    assert_ranks_agree([out[loss]["value"] for out in runs["spatial_ops"]])
    got = runs["spatial_ops"][0][loss]
    assert_close(got["value"], v.detach(), CRPS_RTOL, 0.0, "value")
    assert_close(got["grad_ens"], ens.grad, CRPS_RTOL, CRPS_ATOL, "d ensemble")
    assert_close(got["grad_tgt"], tgt.grad, CRPS_RTOL, CRPS_ATOL, "d target")
