"""The spatially sharded step's remaining options, on gloo ranks spawned
on the CPU (``tests/torch_mp.py``; one spawn of two ranks and one of
four for the file): the WMSE + MS-SSIM and L1 ELBOs on ("data",
"spatial") meshes of 1 x 2 and 1 x 4 (at 128x128 and four ranks,
MS-SSIM's coarsest scale leaves each rank 2 of its 8 rows, fewer than
the window's 3-row halo), the ``mse+ssim`` data range over the global
batch on 2 x 1 and 2 x 2 meshes, bilinear interpolation and the ``lr_*``
pipelines of ``preprocess_batch`` over a block of rows, and the member-mesh
sample step under bilinear interpolation.

Tolerances:
- the train steps against JAX's ``make_train_step`` on one device (the
  tiny model at 128x128, dropout 0, the same posterior noise, one AdamW
  step): loss, recon, kl_mean and grad_norm rtol 1e-4, the parameters
  rtol 2e-3 / atol 2e-5 (JAX ``tests/test_parallel.py:83``) wherever the
  step's gradient lies above 2e-5 of the largest, and within 2 lr where
  it lies at rounding level (Adam's first update is about +-lr whatever
  the gradient's size: ``_against_jax``);
- the same steps against the port's one-process step: the metrics rtol
  1e-5, the gradients AdamW receives within 1e-5 of the largest (the
  block's partial sums add in another order than the whole image's); on
  the 2 x 1 and 2 x 2 meshes the ``msssim`` metric (1 - MS-SSIM, about
  0.00264) within two f32 steps of MS-SSIM at its value (1.19e-7): rtol
  1e-5 of it is 2.6e-8, below the one step (2.98e-8 apart in a run) that
  a sum in another order moves it;
- ``ms_ssim(rows=)`` against unsharded autograd in f32: value rtol 1e-5,
  x's gradient within 1e-5 of the largest;
- ``preprocess_batch(rows=)`` under bilinear interpolation: bit for bit
  against the port's whole batch sliced (4x is a power of two, so the
  padded block's source coordinates are the image's less a whole number
  exactly; the ``pertimestep`` item statistics are sums over the ranks, so
  those cases rtol 1e-6 / atol 1e-6), and against the JAX package's
  ``preprocess_batch`` on the whole batch rtol 1e-5 / atol 1e-5
  (``tests/test_torch_data.py``'s tolerance: ``jax.image.resize`` weighs
  the rows with its own arithmetic, not bit-equal to ``F.interpolate``);
- the member-mesh sample under bilinear interpolation against the
  one-process sample on the same noise: rtol / atol 1e-4, as
  ``test_torch_parallel_spatial_mesh.py``'s sample (HR fields up to ~10
  in magnitude; the blocks' GroupNorm sums add in another order, which
  moved them up to 4.6e-5 here, and the bilinear rows themselves are bit
  for bit, as above).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_mp import spawn, tiny_cfg
from torch_parity import assert_close, jax_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)
from torch_spatial import (
    assert_grads_close,
    assert_metrics_close,
    assert_ranks_agree,
    hr_fields,
    jax_train_step,
    one_process,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RES = 128                 # MS-SSIM at win_size 7 needs sides above 96
RESOLUTION = (RES, RES)
B, M, M_SAMPLE = 2, 2, 3
LOSS_RTOL = 1e-4
JAX_PARAM_RTOL, JAX_PARAM_ATOL = 2e-3, 2e-5
RTOL = 1e-5
MSSSIM_STEPS = 2          # f32 steps of MS-SSIM: the data-parallel steps' msssim metric
ITEM_RTOL, ITEM_ATOL = 1e-6, 1e-6
JAX_PRE_RTOL, JAX_PRE_ATOL = 1e-5, 1e-5
SAMPLE_RTOL, SAMPLE_ATOL = 1e-4, 1e-4
LOSSES = {"mse+ssim": dict(loss_type="mse+ssim", alpha_w=0.01, beta_w=0.05, lam_w=0.4),
          "l1": dict(loss_type="l1", beta_2=0.3)}
ROUTES = {"mse+ssim": "kernel", "l1": "composed"}
PIPELINES = ("lr_to_hr", "lr_to_residuals", "lrinterp_to_residuals", "lrinterp_to_hr")
PREPROCESS = [(p, s) for p in PIPELINES for s in ("perpixel", "pertimestep")]
# (n_data, n_spatial) of each world's step cases
MESHES = {2: [(1, 2), (2, 1)], 4: [(1, 4), (2, 2)]}


def _params():
    return jax_tiny_model(img_resolution=RESOLUTION)[1]


def _stats(inputs):
    from probunet_tpu_torch.data.climex import Standardization

    return Standardization(*(torch.from_numpy(a) for a in inputs["stats"]))


@pytest.fixture(scope="module")
def inputs():
    from probunet_tpu_torch.data.climex import compute_stats

    rng = np.random.default_rng(15)
    hr = hr_fields(41, B, RES)
    # the second day's fields at three times the first's spread: the items'
    # target ranges differ, so a slab's range is not the global batch's
    hr[1] = hr[1].mean() + 3.0 * (hr[1] - hr[1].mean())
    x = rng.standard_normal((B, RES, RES, 3)).astype(np.float32)
    # the per-pixel statistics of the preprocessing and sample checks: over
    # 16 days, as a split's (two days' std would blow the fields up)
    stats = compute_stats(torch.from_numpy(np.concatenate([hr, hr_fields(42, 14, RES)])), 4)
    return {"hr": hr, "stats": tuple(a.numpy() for a in stats), "eps": {"mse+ssim": rng.standard_normal((M, B, 4)).astype(np.float32),
                              "l1": rng.standard_normal((B, 4)).astype(np.float32)},
            "x": x, "y": (x + 0.5 * rng.standard_normal(x.shape)).astype(np.float32),
            "eps_sample": rng.standard_normal((M_SAMPLE, B, 4)).astype(np.float32)}


def _step_case(inputs, loss, n_data, n_spatial):
    return dict(name=f"{loss} {n_data}x{n_spatial}", hr=inputs["hr"], m=M, fused=True,
                dropout=0.0, gn_impl=ROUTES[loss], eps=inputs["eps"][loss], steps=1,
                loss=LOSSES[loss], params=_params(), n_data=n_data, n_spatial=n_spatial)


def _step_cases(inputs, world):
    out = []
    for n_data, n_spatial in MESHES[world]:
        losses = ("mse+ssim", "l1") if n_data == 1 else ("mse+ssim",)
        out += [_step_case(inputs, loss, n_data, n_spatial) for loss in losses]
    return out


def _spawn(inputs, wd, world):
    torch.save({"params": _params(), "cases": _step_cases(inputs, world)},
               wd / "spatial_step.in.pt")
    torch.save({"params": _params(), "cases": [dict(
        name="bilinear", hr=inputs["hr"], eps=inputs["eps_sample"], n_member=1,
        n_spatial=world, stats=inputs["stats"], standardization="perpixel",
        data={"interp_mode": "bilinear"})]}, wd / "spatial_member.in.pt")
    torch.save({"params": _params(), "x": inputs["x"], "y": inputs["y"], "data_range": 4.5,
                "hr": inputs["hr"], "stats": inputs["stats"], "preprocess": PREPROCESS},
               wd / "spatial_losses.in.pt")
    jobs = ("spatial_step", "spatial_member", "spatial_losses")
    spawn(list(jobs), wd, world=world, timeout=300)
    return {job: [torch.load(wd / f"{job}.rank{r}.pt", weights_only=False)
                  for r in range(world)] for job in jobs}


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """One spawn of two gloo ranks and one of four, started side by side
    in the background (the JAX steps compile meanwhile)."""
    with ThreadPoolExecutor(len(MESHES)) as pool:
        yield {world: pool.submit(_spawn, inputs,
                                  tmp_path_factory.mktemp(f"spatial_losses{world}"), world)
               for world in MESHES}


@pytest.fixture(scope="module")
def runs(spawned, jax_steps):
    """Each world's jobs' outputs by rank."""
    return {world: job.result() for world, job in spawned.items()}


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """JAX's one-device step of each ELBO on the global batch."""
    mp = pytest.MonkeyPatch()
    try:
        return {loss: jax_train_step(mp, inputs["hr"], inputs["eps"][loss], LOSSES[loss])
                for loss in LOSSES}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def one_process_steps(inputs):
    """The port's one-process step of each ELBO on the global batch."""
    return {loss: one_process(_step_case(inputs, loss, 1, 1)) for loss in LOSSES}


def _step_out(runs, world, name):
    outs = [r[name] for r in runs[world]["spatial_step"]]
    assert_ranks_agree(outs)
    return outs[0]


def _against_jax(got, want, what):
    """The step's metrics and parameters against JAX's. Adam's first update
    is lr * g / (|g| + 1e-8), about +-lr wherever |g| > 1e-8, so an element
    whose gradient lies at rounding level may move either way (the L1
    ELBO's sign gradients cancel to such elements: one of 576 in
    ``unet.dec_128x128_block0.conv1.weight``, 5e-8 against a largest
    0.021, moved 1.6e-4 from JAX's on the 1 x 2 mesh). The parameters are
    held to JAX's wherever the step's gradient is clear of the gradient
    tolerance (above 2 * RTOL of the largest, which an error within it
    cannot change the sign of), and within 2 lr elsewhere."""
    from torch_parity import torch_tiny_model

    met, params = want
    assert_metrics_close(got["metrics"][0], met, LOSS_RTOL, what)
    for name in ("wmse", "msssim", "kl2_mean"):
        if name in met:
            assert_close(got["metrics"][0][name], met[name], LOSS_RTOL, 0.0, f"{what} {name}")
    grads = got["grads"][0]
    largest = max(float(g.abs().max()) for g in grads)
    names = [k for k, _ in torch_tiny_model(_params(), img_resolution=RESOLUTION)
             .named_parameters()]
    lr = tiny_cfg(B, M).train.lr
    for k, g in zip(names, grads):
        clear = g.abs() > 2 * RTOL * largest
        p, v = got["params"][k], torch.as_tensor(params[k])
        assert_close(p[clear], v[clear], JAX_PARAM_RTOL, JAX_PARAM_ATOL, f"{what} {k}")
        assert float((p - v).abs().max()) <= 2 * lr, f"{what} {k}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("loss", ["mse+ssim", "l1"])
def test_spatial_step_matches_jax(runs, jax_steps, loss, world):
    """make_parallel_train_step of the ELBO on a 1 x ``world`` ("data",
    "spatial") mesh against JAX's make_train_step on one device: MS-SSIM
    through a halo exchange a scale (the rows of windows that cross the
    image's edges left out) and WMSE / L1 through sums over the ranks."""
    _against_jax(_step_out(runs, world, f"{loss} 1x{world}"), jax_steps[loss],
                 f"{loss} 1x{world} vs JAX")


def _against_one_process(got, want, what, msssim_steps=None):
    """The step's metrics (``wmse``, ``msssim``, ``recon_per_channel`` and
    ``kl2_mean`` too) and the gradients AdamW receives against the port's
    one-process step's; ``msssim_steps``: ``msssim`` within that many f32
    steps of MS-SSIM at its value instead of rtol."""
    mets, grads, _ = want
    names = ("loss", "recon", "kl_mean", "grad_norm", "wmse", "msssim", "recon_per_channel",
             "kl2_mean")
    if msssim_steps is not None:
        names = tuple(k for k in names if k != "msssim")
        steps = msssim_steps * np.spacing(np.float32(1.0 - float(mets[0]["msssim"])))
        assert_close(got["metrics"][0]["msssim"], mets[0]["msssim"], 0.0, float(steps),
                     f"{what} msssim")
    assert_metrics_close(got["metrics"][0], mets[0], RTOL, what,
                         names=[k for k in names if k in mets[0]])
    assert_grads_close(got["grads"][0], grads[0], RTOL, what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("loss", ["mse+ssim", "l1"])
def test_spatial_step_matches_single_process(runs, one_process_steps, loss, world):
    """The same steps against the port's one-process step."""
    _against_one_process(_step_out(runs, world, f"{loss} 1x{world}"), one_process_steps[loss],
                         f"{loss} 1x{world}")


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_data_parallel_msssim_step_takes_the_global_data_range(runs, jax_steps,
                                                               one_process_steps, mesh):
    """The ``mse+ssim`` step over a "data" axis of 2 (with and without a
    "spatial" axis) equals JAX's one-device step on the global batch, and
    the port's one-process step: its MS-SSIM data range is the global
    batch's targets' max - min, one all-reduce of (max, -min), not the
    slab's. The two days' ranges differ (the second's fields spread three
    times wider), so a slab's range moves the step beyond the tolerances:
    with each slab's range the loss read 1.3e-4 from the one-process
    step's and 9e-5 from JAX's (WMSE dominates it), and 7 of the first
    convolution's 216 weights moved 2 lr from JAX's. Its ``msssim`` metric
    is held within two f32 steps of MS-SSIM."""
    world = 2 if mesh == "2x1" else 4
    got = _step_out(runs, world, f"mse+ssim {mesh}")
    _against_one_process(got, one_process_steps["mse+ssim"], f"mse+ssim {mesh}",
                         msssim_steps=MSSSIM_STEPS)
    _against_jax(got, jax_steps["mse+ssim"], f"mse+ssim {mesh} vs JAX")


@pytest.mark.parametrize("world", [2, 4])
def test_ms_ssim_of_blocks_matches_unsharded_autograd(inputs, runs, world):
    """ms_ssim(rows=) on each rank's block: the whole image's value on
    every rank, and the mean over the axis of each rank's gradient of it is
    the unsharded gradient, the 2-row blocks of the coarsest scale on four
    ranks included (their halo taken from ranks beyond the neighbours)."""
    from probunet_tpu_torch.ops.msssim import ms_ssim

    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    want = ms_ssim(x, torch.from_numpy(inputs["y"]), torch.tensor(4.5), win_size=7)
    want.backward()
    outs = [r["ms_ssim"] for r in runs[world]["spatial_losses"]]
    assert_ranks_agree(outs)
    assert_close(outs[0]["value"], want.detach(), RTOL, 0.0, "ms_ssim")
    assert_grads_close([outs[0]["grad"]], [x.grad], RTOL, "d ms_ssim / dx")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("pipeline,standardization", PREPROCESS)
def test_bilinear_preprocess_of_blocks(inputs, runs, world, pipeline, standardization):
    """preprocess_batch(rows=) under bilinear interpolation, each pipeline
    (the ``lr_*`` ones pool the LR block locally; ``lr_to_residuals``
    upsamples the standardized LR block): the gathered blocks are the
    port's whole batch's outputs, and the JAX package's."""
    import jax.numpy as jnp

    from probunet_tpu.data import climex as jc
    from probunet_tpu_torch.data.climex import preprocess_batch

    hr = inputs["hr"]
    args = (pipeline, 4, "bilinear", 1e-10, standardization)
    whole = preprocess_batch(torch.from_numpy(hr), _stats(inputs), *args)
    want = jc.preprocess_batch(jnp.asarray(hr), jc.Standardization(*inputs["stats"]), *args)
    outs = [r[f"{pipeline} {standardization}"] for r in runs[world]["spatial_losses"]]
    assert_ranks_agree(outs)
    assert set(outs[0]) == {k for k in ("inputs", "targets", "lrinterp") if k in want}
    for key, got in outs[0].items():
        if standardization == "perpixel":
            assert torch.equal(got, whole[key]), key
        else:
            assert_close(got, whole[key], ITEM_RTOL, ITEM_ATOL, key)
        assert_close(got, want[key], JAX_PRE_RTOL, JAX_PRE_ATOL, f"{key} vs JAX")


@pytest.mark.parametrize("world", [2, 4])
def test_bilinear_member_sample_matches_single_process(inputs, runs, world):
    """make_parallel_sample_step on a 1 x ``world`` x 1 ("data", "spatial",
    "member") mesh under bilinear interpolation: each rank's LR block and
    its lrinterp baseline take a row of each neighbour; the gathered HR
    ensemble is the one-process sample's on the same noise."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import (lrinterp_from_batch, preprocess_batch,
                                                residual_to_hr)

    hr = torch.from_numpy(inputs["hr"])
    stats = _stats(inputs)
    model = torch_tiny_model(_params(), img_resolution=RESOLUTION)
    batch = preprocess_batch(hr, stats, "lrinterp_to_residuals", 4, "bilinear")
    with torch.no_grad():
        out = model.sample(batch["inputs"], M_SAMPLE, eps=torch.from_numpy(inputs["eps_sample"]))
    want = residual_to_hr(out, lrinterp_from_batch(batch, 4, "bilinear")[:, None], stats)
    outs = [r["bilinear"] for r in runs[world]["spatial_member"]]
    assert_ranks_agree(outs)
    assert tuple(outs[0].shape) == (B, M_SAMPLE, RES, RES, 3)
    assert_close(outs[0], want, SAMPLE_RTOL, SAMPLE_ATOL, "bilinear sample")


@pytest.mark.parametrize("world", [2, 4])
def test_lr_pipeline_step_raises_as_the_one_process_step(inputs, runs, world):
    """The Probabilistic U-Net cannot train on an ``lr_*`` pipeline (its
    posterior joins the LR input with the HR target), in the JAX package's
    one-device step as in the port's one-process step: over a spatial mesh
    the step raises the same error, on every rank."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.train.loop import make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    hr = torch.from_numpy(inputs["hr"])
    cfg = tiny_cfg(B, 2, resolution=RESOLUTION, pipeline="lr_to_residuals")
    model = torch_tiny_model(_params(), img_resolution=RESOLUTION)
    state = create_train_state(model, seed=cfg.train.seed, device="cpu")
    with pytest.raises(RuntimeError) as one:
        make_train_step(model, cfg)(state, hr, compute_stats(hr, 4), 1.0, 0.1)
    got = [r["lr step"] for r in runs[world]["spatial_losses"]]
    assert got == [type(one.value).__name__] * world, got
