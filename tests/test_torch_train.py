"""The training slice, port against JAX, on the tiny model (CPU).

- The training ELBO's loss and every parameter gradient, dropout on, on
  both reconstruction routes and both losses, with the U-Net's GroupNorm
  chains on the composed route (torch composition + kernel D); and on the
  kernel route (kernels C and C′) for afCRPS fused. The
  JAX side is ``ProbabilisticUNet.elbo(training=True)`` itself, with
  ``PROBUNET_DROPOUT_IMPL=pallas`` (the dropout kernel in interpret mode),
  ``PROBUNET_GN_IMPL`` matching the port's route (``pallas`` for the
  kernel route) and ``PROBUNET_FUSED_ELBO`` choosing the reconstruction.
  A test-side wrapper records the seed words each U-Net block hands its
  dropout (``torch_parity.jax_elbo_grads``), and the posterior's rsample
  takes numpy noise; the port gets the same seed words and noise.
  Gradients are compared leaf by leaf through ``convert.py``'s mapping.
  f32, rtol 1e-4 / atol 1e-5 as the model tests: the same sums in other
  orders through ~20 layers, forward and back.
- AdamW (with ``grad_clip`` and ``accum``) against
  ``probunet_tpu.train.state.make_optimizer``: three updates on the same
  gradients, rtol 1e-5 / atol 1e-7 (the same f32 formula, one or two
  roundings in another order per step).
- Checkpoint resume (bit for bit), ``beta_schedule`` and ``EarlyStopper``
  against the JAX functions, and ``Trainer.fit`` on the CPU.
- ``train_epoch``'s rate leaves its first step out (a fake clock).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import TINY, assert_close, jax_elbo_grads, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch.convert import convert_params, flax_params
from probunet_tpu_torch.data import climex as tclimex
from probunet_tpu_torch.data.synthetic import synthetic_climex_fields

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RTOL, ATOL = 1e-4, 1e-5
DROPOUT, B, M = 0.1, 2, 4


def _batch(seed):
    rng = np.random.default_rng(seed)
    h, w = TINY["img_resolution"]
    x = rng.standard_normal((B, h, w, TINY["input_channels"])).astype(np.float32)
    y = rng.standard_normal((B, h, w, TINY["num_classes"])).astype(np.float32)
    eps = rng.standard_normal((M, B, TINY["latent_dim"])).astype(np.float32)
    return x, y, eps


@pytest.fixture(scope="module")
def dropout_models():
    """The JAX model and the port's on the composed GroupNorm route."""
    jmodel, params = jax_tiny_model(dropout=DROPOUT)
    return jmodel, params, torch_tiny_model(params, dropout=DROPOUT, gn_impl="composed")


@pytest.mark.parametrize("loss_type,fused", [("afcrps", True), ("afcrps", False),
                                             ("crps", True), ("crps", False)])
def test_training_elbo_gradients_match_jax(dropout_models, monkeypatch, loss_type, fused):
    _check_training_elbo(monkeypatch, *dropout_models, loss_type, fused, "composed")


@pytest.mark.parametrize("loss_type,fused", [("afcrps", True)])
def test_training_elbo_gradients_match_jax_kernel_route(dropout_models, monkeypatch,
                                                        loss_type, fused):
    """Kernels C and C′ against the JAX model under PROBUNET_GN_IMPL=pallas,
    their dropout masks from the seed words the JAX blocks hand kernel C
    (and kernel D, for the shapes C does not take). One reconstruction
    route: the U-Net's backward is the same under either."""
    jmodel, params, _ = dropout_models
    tmodel = torch_tiny_model(params, dropout=DROPOUT, gn_impl="kernel")
    _check_training_elbo(monkeypatch, jmodel, params, tmodel, loss_type, fused, "kernel")


def _check_training_elbo(monkeypatch, jmodel, params, tmodel, loss_type, fused, gn_impl):
    x, y, eps = _batch(3)
    beta_1 = 0.7
    want_total, want_met, want_grads, seeds = jax_elbo_grads(
        monkeypatch, jmodel, params, x, y, eps, loss_type, fused, beta_1, M, gn_impl)
    assert seeds.shape == (len(tmodel.unet.dropout_blocks), 2)  # every block, no fallback
    tmodel.zero_grad()
    total, met = tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y), M=M,
                             loss_type=loss_type, beta_1=beta_1, eps=torch.from_numpy(eps),
                             fused=fused, training=True, seeds=torch.from_numpy(seeds))
    total.backward()
    assert_close(total.detach(), want_total, RTOL, ATOL, "loss")
    assert_close(met["recon"].detach(), want_met["recon"], RTOL, ATOL, "recon")
    assert_close(met["kl"].detach(), want_met["kl"], RTOL, ATOL, "kl")
    want = convert_params(want_grads, tmodel)
    for name, prm in tmodel.named_parameters():
        assert prm.grad is not None, name
        assert_close(prm.grad, want[name], RTOL, ATOL, f"d{name}")
    # dropout is on: the same loss without it differs
    with torch.no_grad():
        off, _ = tmodel.elbo(torch.from_numpy(x), torch.from_numpy(y), M=M,
                             loss_type=loss_type, beta_1=beta_1, eps=torch.from_numpy(eps),
                             fused=fused)
    assert abs(float(off) - float(total.detach())) > 1e-4


def test_dropout_sees_row_major_nhwc_views(dropout_models):
    """The activations reach the dropout kernel as the NHWC view of a
    channels_last tensor, row-major contiguous: the layout the CUDA wrapper
    requires (a non-contiguous view raises there)."""
    from probunet_tpu_torch.models import layers

    _, _, tmodel = dropout_models
    seen = []
    real = layers.hash_dropout

    def spy(x, seed2, p):
        seen.append((tuple(x.shape), x.is_contiguous()))
        return real(x, seed2, p)

    x, y, eps = _batch(4)
    layers.hash_dropout = spy
    try:
        with torch.no_grad():
            tmodel.unet(torch.from_numpy(x), train=True,
                        generator=torch.Generator().manual_seed(0))
    finally:
        layers.hash_dropout = real
    assert len(seen) == len(tmodel.unet.dropout_blocks)
    assert all(contig and shape[-1] in (8, 16) for shape, contig in seen), seen


@pytest.mark.parametrize("grad_clip,accum", [(0.0, 1), (0.5, 1), (0.5, 2)])
def test_adamw_matches_optax(grad_clip, accum):
    import optax

    from probunet_tpu.train.state import make_optimizer as jax_make_optimizer

    from probunet_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(int(10 * grad_clip) + accum)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(0.3 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for _ in range(3 * accum)]
    for g in grads:
        g[1][:] = 0.0  # a parameter without gradient is still decayed
    tx = jax_make_optimizer(lr=1e-2, weight_decay=0.05, grad_clip=grad_clip, accum=accum)
    jp = [jnp.asarray(a) for a in p0]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = make_optimizer(tp, lr=1e-2, weight_decay=0.05, grad_clip=grad_clip, accum=accum)

    @jax.jit  # one compile, not one per eager operation
    def jax_step(g, opt_state, jp):
        upd, opt_state = tx.update(g, opt_state, jp)
        return optax.apply_updates(jp, upd), opt_state

    for i, g in enumerate(grads):
        jp, opt_state = jax_step([jnp.asarray(a) for a in g], opt_state, jp)
        updated = opt.step([torch.from_numpy(a) for a in g])
        assert updated == ((i + 1) % accum == 0)
        for t, j in zip(tp, jp):
            assert_close(t.detach(), np.asarray(j), 1e-5, 1e-7, f"step {i}")
    assert not np.allclose(tp[1].detach().numpy(), p0[1])


def _tiny_cfg():
    from probunet_tpu_torch.config import preset

    cfg = preset("probunet_multivar_128")
    m = cfg.model
    m.latent_dim, m.num_filters, m.model_channels = (TINY["latent_dim"], TINY["num_filters"],
                                                     TINY["model_channels"])
    m.channel_mult, m.num_blocks = TINY["channel_mult"], TINY["num_blocks"]
    cfg.data.resolution, cfg.data.lowres_scale = TINY["img_resolution"], 4
    cfg.train.batch_size, cfg.train.ensemble_size, cfg.train.eval_ensemble_size = B, M, 3
    return cfg


@pytest.fixture(scope="module")
def tiny_data():
    cfg = _tiny_cfg()
    phys = synthetic_climex_fields(5 * B, *cfg.data.resolution, seed=9)
    from probunet_tpu_torch.data.transforms import apply_physical_transform

    hr = apply_physical_transform(torch.from_numpy(phys), cfg.data.variables)
    return cfg, hr, tclimex.compute_stats(hr, cfg.data.lowres_scale)


def _tiny_state(cfg, params):
    from probunet_tpu_torch.train.state import create_train_state

    model = torch_tiny_model(params, dropout=DROPOUT)
    return create_train_state(model, seed=cfg.train.seed, lr=1e-3, device="cpu")


def test_train_step_resumes_bit_for_bit(dropout_models, tiny_data, tmp_path):
    """Three steps in a row equal one step, a checkpoint, a fresh state
    restored from it and two more steps: the step's noise and seed words
    derive from (seed, step)."""
    from probunet_tpu_torch.train.checkpoint import CheckpointManager
    from probunet_tpu_torch.train.loop import make_train_step

    _, params, _ = dropout_models
    cfg, hr, stats = tiny_data
    batches = list(hr.split(B))[:3]

    def run(state, hrs):
        step = make_train_step(state.model, cfg, fused=True)
        out = []
        for h in hrs:
            state, met = step(state, h, stats, 1.0, 0.5)
            out.append(met)
        return state, out

    straight, mets = run(_tiny_state(cfg, params), batches)
    assert all(math.isfinite(float(v)) for m in mets for v in m.values())
    first, _ = run(_tiny_state(cfg, params), batches[:1])
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(first.step, first, extra={"epoch": 1})
    resumed = _tiny_state(cfg, params)
    resumed, extra = ckpt.restore(resumed)
    assert resumed.step == 1 and extra == {"epoch": 1}
    resumed, mets2 = run(resumed, batches[1:])
    assert float(mets2[-1]["loss"]) == float(mets[-1]["loss"])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_train_step_equals_elbo_and_optimizer(dropout_models, tiny_data):
    """One step with given noise and seed words: the ELBO's gradients,
    their global norm and one AdamW update."""
    from probunet_tpu_torch.train.loop import make_train_step
    from probunet_tpu_torch.train.state import global_norm

    _, params, _ = dropout_models
    cfg, hr, stats = tiny_data
    state = _tiny_state(cfg, params)
    ref = torch_tiny_model(params, dropout=DROPOUT)
    _, _, eps = _batch(5)
    seeds = torch.arange(2 * len(ref.unet.dropout_blocks), dtype=torch.int32).reshape(-1, 2)
    batch = tclimex.preprocess_batch(hr[:B], stats, cfg.data.pipeline, cfg.data.lowres_scale)
    total, _ = ref.elbo(batch["inputs"], batch["targets"], M=M, beta_1=0.0,
                        eps=torch.from_numpy(eps), training=True, seeds=seeds)
    total.backward()
    state, met = make_train_step(state.model, cfg)(state, hr[:B], stats, 1.0, 0.0,
                                                   eps=torch.from_numpy(eps), seeds=seeds)
    assert float(met["loss"]) == float(total)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ref.parameters()]
    assert float(met["grad_norm"]) == pytest.approx(float(global_norm(grads)), rel=1e-6)
    # beta_1 = 0: the prior gets zero gradients and is still decayed
    prior_w = next(ref.prior.parameters())
    moved = next(state.model.prior.parameters())
    assert not torch.equal(prior_w, moved)
    assert state.step == 1


def test_beta_schedule_and_early_stopper_match_jax():
    from probunet_tpu.train.early_stop import EarlyStopper as JaxStopper
    from probunet_tpu.train.schedule import beta_schedule as jax_schedule

    from probunet_tpu_torch.train.early_stop import EarlyStopper
    from probunet_tpu_torch.train.schedule import beta_schedule

    for num_epochs in (1, 3, 10):
        for warmup in (0, 2, 5):
            for max_b in (0.5, 1.0):
                for epoch in range(1, num_epochs + 1):
                    assert beta_schedule(epoch, num_epochs, warmup, max_b) == jax_schedule(
                        epoch, num_epochs, warmup, max_b)
    losses = [3.0, 2.0, 2.5, 1.0, 1.5, 1.6, 1.7, 0.5]
    for patience, delta in ((1, 0.0), (2, 0.0), (2, 0.6), (3, 0.1)):
        js, ts = JaxStopper(patience, delta), EarlyStopper(patience, delta)
        for i, v in enumerate(losses):
            jstop, jp = js.early_stop(v, {"w": jnp.full((2,), float(i))})
            tstop, tp = ts.early_stop(v, {"w": torch.full((2,), float(i))})
            assert (jstop, js.counter) == (tstop, ts.counter)
            assert np.array_equal(np.asarray(jp["w"]), tp["w"].numpy())
            if tstop:
                break


def _datasets(hr, cfg):
    """Training and validation ClimexDatasets over the first 3 and the last
    2 batches of ``hr``, each with its own statistics."""
    kw = dict(variables=cfg.data.variables, pipeline=cfg.data.pipeline,
              lowres_scale=cfg.data.lowres_scale, device="cpu")
    return (tclimex.ClimexDataset(hr=hr[:3 * B].numpy(), **kw),
            tclimex.ClimexDataset(hr=hr[3 * B:].numpy(), **kw))


def test_trainer_fit_two_epochs_on_cpu(dropout_models, tiny_data, tmp_path):
    from probunet_tpu_torch.train.checkpoint import CheckpointManager
    from probunet_tpu_torch.train.logging import MetricLogger
    from probunet_tpu_torch.train.loop import Trainer

    _, params, _ = dropout_models
    cfg, hr, stats = tiny_data
    cfg.train.log_every = 1
    logger = MetricLogger(str(tmp_path / "logs"), stdout=False)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    ds_train, ds_val = _datasets(hr, cfg)
    trainer = Trainer(cfg, torch_tiny_model(params, dropout=DROPOUT), ds_train, ds_val,
                      logger=logger, checkpoint_manager=ckpt, device="cpu")
    hist = trainer.fit(2)
    assert all(len(v) == 2 and all(math.isfinite(x) for x in v) for v in hist.values())
    assert trainer.state.step == 6 and ckpt.steps() == [6]
    assert [r["kind"] for r in logger.history].count("epoch") == 2
    logger.close()


def test_train_epoch_rate_leaves_the_first_step_out(monkeypatch):
    """On a fake clock where the first step takes 10 s and each later one
    1 s, the epoch's rate is one step a second and ``first_step_s`` 10."""
    import time
    from types import SimpleNamespace

    from probunet_tpu_torch.train.loop import train_epoch

    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    cfg = _tiny_cfg()

    class Days:
        def __len__(self):
            return 5 * B

        def get_hr_batch(self, idx):
            return np.zeros((len(idx), 1), np.float32)

    state = SimpleNamespace(model=torch.nn.Linear(1, 1), step=0)

    def step_fn(state, hr, stats, beta_0, beta_1):
        clock[0] += 10.0 if state.step == 0 else 1.0
        state.step += 1
        return state, {"recon": torch.tensor(1.0), "kl_mean": torch.tensor(0.5)}

    state, out = train_epoch(step_fn, state, Days(), None, cfg, 1.0, 0.0, epoch=1)
    assert state.step == 5 and out["first_step_s"] == 10.0
    assert out["steps_per_sec"] == 1.0 and out["samples_per_sec"] == B
    assert (out["recon"], out["kl"]) == (1.0, 0.5)


def test_entry_points_default_to_cuda():
    """Without a CUDA device the entry points raise unless asked for the CPU."""
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.train.loop import Trainer
    from probunet_tpu_torch.train.state import create_train_state

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0))
    model = ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model)
    hr = np.ones((B, *cfg.data.resolution, 3), np.float32)
    ds = tclimex.ClimexDataset(hr=hr, lowres_scale=cfg.data.lowres_scale, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, model, ds)
    assert flax_params(model)  # the CPU model is whole


def test_trainer_resumes_and_validates_on_the_validation_stats(dropout_models, tiny_data,
                                                                tmp_path, monkeypatch):
    """A Trainer restored from the first one's checkpoint continues from its
    step (the epochs count from 1 again, as in the JAX CLI); validation
    scores the validation split with that split's own statistics; the
    per-epoch figures are drawn; ``mesh=`` takes a ``parallel.mesh.Mesh``
    and raises on anything else (the data-parallel Trainer is held in
    ``test_torch_parallel_steps.py``)."""
    from probunet_tpu_torch.train import loop
    from probunet_tpu_torch.train.checkpoint import CheckpointManager

    _, params, _ = dropout_models
    cfg, hr, _ = tiny_data
    ds_train, ds_val = _datasets(hr, cfg)
    seen = []
    real = loop.eval_model
    monkeypatch.setattr(loop, "eval_model",
                        lambda fn, st, ds, stats, *a: seen.append((ds, stats)) or real(
                            fn, st, ds, stats, *a))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    first = loop.Trainer(cfg, torch_tiny_model(params, dropout=DROPOUT), ds_train, ds_val,
                         checkpoint_manager=ckpt, plot_dir=str(tmp_path), device="cpu")
    hist = first.fit(1)
    assert set(hist) == {"train_crps", "train_kl", "val_crps", "val_kl"}
    assert seen[0][0] is ds_val and seen[0][1] is ds_val.device_stats(torch.device("cpu"))
    assert not torch.equal(ds_val.device_stats(torch.device("cpu")).hr_mean,
                           ds_train.device_stats(torch.device("cpu")).hr_mean)
    assert sorted(p.name for p in tmp_path.glob("*_ep001_*.png")) == sorted(
        f"{k}_ep001_{v}.png" for k in ("residual_diffs", "residuals", "samples")
        for v in cfg.data.variables)
    assert ckpt.latest_step() == 3 and (tmp_path / "ckpt" / "best_params.pt").exists()
    second = loop.Trainer(cfg, torch_tiny_model(params, dropout=DROPOUT), ds_train, ds_val,
                          checkpoint_manager=ckpt, device="cpu")
    second.state, extra = ckpt.restore(second.state, ckpt.latest_step())
    assert second.state.step == 3 and extra["epoch"] == 1
    second.fit(1)
    assert second.state.step == 6 and ckpt.latest_step() == 6
    for a, b in zip(first.model.parameters(), torch_tiny_model(params).parameters()):
        assert not torch.equal(a, b)
    hr_pred, hr_b, lrinterp, resid, tgt = first.sample_ensemble(num_items=2, num_samples=3)
    assert hr_pred.shape == (2, 3, *cfg.data.resolution, 3) and hr_b.shape == lrinterp.shape
    with pytest.raises(TypeError, match="Mesh"):
        loop.Trainer(cfg, first.model, ds_train, mesh=object(), device="cpu")


@pytest.mark.parametrize("loss_type", ["l1", "mse+ssim"])
def test_train_step_returns_the_loss_metrics(dropout_models, tiny_data, loss_type):
    """The step passes the loss config's fields on and returns each ELBO's
    own metrics (mse+ssim at 128x128: a 16x16 grid raises)."""
    from probunet_tpu_torch.train.loop import make_train_step

    _, params, _ = dropout_models
    cfg, hr, stats = tiny_data
    cfg = copy.deepcopy(cfg)
    cfg.loss.loss_type, cfg.loss.beta_2 = loss_type, 0.5
    state = _tiny_state(cfg, params)
    step = make_train_step(state.model, cfg)
    if loss_type == "mse+ssim":
        with pytest.raises(ValueError, match="too small"):
            step(state, hr[:B], stats, 1.0, 0.1)
        return
    state, met = step(state, hr[:B], stats, 1.0, 0.1)
    assert set(met) == {"loss", "grad_norm", "recon", "kl_mean", "recon_per_channel",
                        "kl2_mean"}
    assert met["recon_per_channel"].shape == (3,)
    total = met["recon"] + 0.1 * met["kl_mean"] + 0.5 * met["kl2_mean"]
    assert float(met["loss"]) == pytest.approx(float(total), rel=1e-6)
