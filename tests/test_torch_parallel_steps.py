"""The port's data- and member-parallel paths (``probunet_tpu_torch/parallel``)
on two gloo ranks spawned on the CPU (``tests/torch_mp.py``), against the
JAX package on the suite's 8-device virtual mesh and against the port's
own single-process steps; and the dropout offsets of kernels C, C′ and D
(their plain versions) that make a rank's slab drop what the whole batch
drops.

All two-rank runs of this file share one spawn (the ``runs`` fixture).

Tolerances:
- the data-parallel step against JAX's (dropout 0, as JAX's own test,
  the same posterior noise): loss, recon, kl_mean and the all-reduced
  gradients' norm rtol 1e-4 (JAX ``tests/test_parallel.py:83``'s loss
  bound); the parameters after one AdamW step atol 6e-5, 0.6 of the
  learning rate. Adam's first step moves each parameter by lr * g / (|g| +
  1e-8), about +-lr wherever |g| > 1e-8, so it keeps only each gradient's
  sign, and where a gradient lies below the two packages' agreement
  (atol 1e-5, ``test_torch_train.py``) the signs may differ: in this run
  12.7% of the update of ``posterior.enc0_conv0.weight``, up to 5.6e-5,
  every other tensor's update within 1e-3 of JAX's in norm. A missing or
  reversed update (lr or 2 lr off) fails;
- the data-parallel step with dropout 0.1 against the port's
  single-process step on the whole batch, two steps: loss, recon, kl_mean
  and grad_norm rtol 1e-5, parameters atol 1e-6 (the two ranks' half-batch
  gradients summed in another order than one batch's, nothing else);
- the data-parallel step with int8 saved convolution inputs
  (``act_compress``, dropout 0.1, the composed route) against the port's
  compressed single-process step: the same bounds (each convolution's
  absmax is the MAX over both ranks' slabs, so the int8 copies equal the
  whole batch's); with each rank's own absmax (a planted fault) the same
  check fails;
- ``Trainer(mesh=)`` against the single-process ``Trainer``: the history
  rtol 1e-5;
- the member-sharded ensemble against JAX's on the same noise: rtol / atol
  1e-4 on HR fields of magnitude up to ~4 (``test_torch_cli.py``'s rtol
  1e-4 for the model through two libraries' convolutions; the JAX test's
  1e-5 holds one library against itself; measured 4.5e-5);
- the offset masks: bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from torch_mp import spawn, tiny_cfg
from torch_parity import assert_close, jax_tiny_model, torch_tiny_model
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

B, M, M_SAMPLE = 8, 3, 8
DROPOUT = 0.1
LOSS_RTOL = 1e-4
JAX_PARAM_ATOL = 6e-5
DP_RTOL, DP_PARAM_ATOL = 1e-5, 1e-6
HIST_RTOL = 1e-5
SAMPLE_RTOL, SAMPLE_ATOL = 1e-4, 1e-4
DROP_ROUTES = ("kernel", "composed")


def _hr(seed: int, n: int = B) -> np.ndarray:
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields
    from probunet_tpu_torch.data.transforms import apply_physical_transform

    phys = synthetic_climex_fields(n, 16, 16, seed=seed)
    return apply_physical_transform(torch.from_numpy(phys), ("pr", "tasmin", "tasmax")).numpy()


@pytest.fixture(scope="module")
def inputs():
    _, params = jax_tiny_model()
    rng = np.random.default_rng(5)
    return {"params": params, "hr": _hr(11),
            "eps": rng.standard_normal((M, B, 4)).astype(np.float32),
            "eps_sample": rng.standard_normal((M_SAMPLE, B, 4)).astype(np.float32),
            # standard normal fields, as JAX's member tests: a dry synthetic
            # day has no spread for the per-timestep standardization
            "hr_normal": rng.standard_normal((B, 16, 16, 3)).astype(np.float32),
            "train": _hr(12, 3 * B), "val": _hr(13, 2 * B)}


def _stats(hr: np.ndarray):
    from probunet_tpu_torch.data.climex import compute_stats

    st = compute_stats(torch.from_numpy(hr), 4)
    return tuple(None if a is None else a.numpy() for a in st)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Each job's outputs by rank, from one spawn of two gloo ranks."""
    wd = tmp_path_factory.mktemp("parallel_steps")
    p, hr = inputs["params"], inputs["hr"]
    cases = [dict(name="jax", hr=hr, m=M, dropout=0.0, gn_impl="composed", fused=True,
                  eps=inputs["eps"], steps=1)]
    cases += [dict(name=f"dropout {r}", hr=hr, m=M, dropout=DROPOUT, gn_impl=r, fused=True,
                   eps=None, steps=2) for r in DROP_ROUTES]
    cases += [dict(name=name, hr=hr, m=M, dropout=DROPOUT, gn_impl="composed", fused=True,
                   eps=None, steps=2, act_compress=True, absmax_per_rank=fault)
              for name, fault in (("act8", False), ("act8 absmax per rank", True))]
    torch.save({"params": p, "cases": cases}, wd / "dp_step.in.pt")
    torch.save({"params": p, "batch": B, "m": M, "dropout": DROPOUT, "epochs": 2,
                "train": inputs["train"], "val": inputs["val"]}, wd / "trainer.in.pt")
    member = []
    for std in ("perpixel", "pertimestep"):
        for n_member in (2, 1):
            member.append(dict(name=f"{std} member{n_member}", hr=inputs["hr_normal"],
                               eps=inputs["eps_sample"], standardization=std,
                               n_member=n_member, stats=_stats(inputs["hr_normal"])))
    torch.save({"params": p, "cases": member}, wd / "member.in.pt")
    spawn(["dp_step", "trainer", "member"], wd)
    return {job: [torch.load(wd / f"{job}.rank{r}.pt", weights_only=False) for r in (0, 1)]
            for job in ("dp_step", "trainer", "member")}


def _assert_ranks_agree(outs):
    """Both ranks return the same values (a replicated result)."""
    a, b = outs
    for x, y in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(torch.as_tensor(x), torch.as_tensor(y), rtol=0, atol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _jax_cfg(batch, m, **data):
    from probunet_tpu.config import Config

    cfg = Config()
    t = tiny_cfg(batch, m, **data)
    for sec in ("data", "model", "train"):
        for k, v in vars(getattr(t, sec)).items():
            setattr(getattr(cfg, sec), k, v)
    return cfg


def test_dp_step_matches_jax_parallel_step(inputs, runs, monkeypatch):
    """make_parallel_train_step on two ranks against JAX's on 8 devices:
    dropout 0, the same posterior noise, one AdamW step."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import compute_stats
    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.parallel import make_mesh, make_parallel_train_step, replicated
    from probunet_tpu.train.state import TrainState, make_optimizer

    jmodel, params = jax_tiny_model()
    eps = jnp.asarray(inputs["eps"])
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * eps)
    state = TrainState.create(apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, params),
                              tx=make_optimizer(), rng=jax.random.key(0))
    mesh = make_mesh()
    cfg = _jax_cfg(B, M)
    stats = compute_stats(jnp.asarray(inputs["hr"]), 4)
    step = make_parallel_train_step(jmodel, cfg, mesh, donate=False)
    rep = replicated(mesh)
    new, met = step(jax.device_put(state, rep), inputs["hr"], jax.device_put(stats, rep),
                    jax.device_put(jnp.float32(1.0), rep), jax.device_put(jnp.float32(0.1), rep))
    _assert_ranks_agree([r["jax"] for r in runs["dp_step"]])
    got = runs["dp_step"][0]["jax"]
    for k in ("loss", "recon", "kl_mean", "grad_norm"):
        assert_close(got["metrics"][0][k], float(met[k]), LOSS_RTOL, 0.0, k)
    from probunet_tpu_torch.convert import convert_params

    want = convert_params(jax.device_get(new.params), torch_tiny_model(params))
    for k, v in want.items():
        assert_close(got["params"][k], v, 0.0, JAX_PARAM_ATOL, k)


@pytest.mark.parametrize("gn_impl", DROP_ROUTES)
def test_dp_step_with_dropout_matches_single_process(inputs, runs, gn_impl):
    """Dropout 0.1 on either GroupNorm route (kernel C under seed words
    shifted by its batch offset, or the composed chain with kernel D's
    element offset and global block height), the draws global: two
    data-parallel steps equal two single-process steps on the whole
    batch."""
    name = f"dropout {gn_impl}"
    _assert_ranks_agree([r[name] for r in runs["dp_step"]])
    got = runs["dp_step"][0][name]
    _assert_matches_single_process(got, inputs, gn_impl)
    # the masks matter: without dropout the step differs
    assert abs(float(got["metrics"][0]["loss"]) - float(runs["dp_step"][0]["jax"]["metrics"][0][
        "loss"])) > 1e-4


def _assert_matches_single_process(got, inputs, gn_impl, act_compress=False):
    """Two data-parallel steps' metrics and parameters against two
    single-process steps on the whole batch (dropout 0.1)."""
    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.train.loop import make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    cfg = tiny_cfg(B, M)
    model = torch_tiny_model(inputs["params"], dropout=DROPOUT, gn_impl=gn_impl,
                             act_compress=act_compress)
    state = create_train_state(model, seed=cfg.train.seed, device="cpu")
    step = make_train_step(model, cfg)
    hr = torch.from_numpy(inputs["hr"])
    stats = compute_stats(hr, 4)
    for i in range(2):
        state, met = step(state, hr, stats, 1.0, 0.1)
        for k in ("loss", "recon", "kl_mean", "grad_norm"):
            assert_close(got["metrics"][i][k], met[k], DP_RTOL, 0.0, f"step {i} {k}")
    for k, v in model.state_dict().items():
        assert_close(got["params"][k], v, 0.0, DP_PARAM_ATOL, k)


def test_dp_step_with_act_compress_matches_single_process(inputs, runs):
    """int8 saved convolution inputs on two ranks: every convolution's
    absmax is the MAX over both slabs (the JAX step's over its global
    batch), so two data-parallel steps equal two compressed single-process
    steps; the same steps with each rank's own absmax do not."""
    _assert_ranks_agree([r["act8"] for r in runs["dp_step"]])
    _assert_matches_single_process(runs["dp_step"][0]["act8"], inputs, "composed", True)
    with pytest.raises(AssertionError):
        _assert_matches_single_process(runs["dp_step"][0]["act8 absmax per rank"], inputs,
                                       "composed", True)


def test_trainer_with_mesh_matches_single_process(inputs, runs, tmp_path):
    """Trainer(mesh=) over two ranks, two epochs with dropout: the history of
    the single-process Trainer (JAX ``test_parallel.py:196``); rank 0
    alone logged."""
    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.train.loop import Trainer

    cfg = tiny_cfg(B, M)
    kw = dict(variables=cfg.data.variables, pipeline=cfg.data.pipeline,
              lowres_scale=cfg.data.lowres_scale, device="cpu")
    t = Trainer(cfg, torch_tiny_model(inputs["params"], dropout=DROPOUT),
                ClimexDataset(hr=inputs["train"], **kw), ClimexDataset(hr=inputs["val"], **kw),
                device="cpu")
    want = t.fit(2)
    r0, r1 = runs["trainer"]
    _assert_ranks_agree([r0["history"], r1["history"]])
    assert r0["step"] == t.state.step == 2 * 3
    for k, v in want.items():
        assert len(r0["history"][k]) == len(v) == 2
        assert_close(r0["history"][k], v, HIST_RTOL, 0.0, k)
    assert r0["logged"] > 0 and r1["logged"] == 0


@pytest.mark.parametrize("standardization", ["perpixel", "pertimestep"])
def test_member_parallel_sample_matches_jax(inputs, runs, monkeypatch, standardization):
    """make_parallel_sample_step on two ranks, members split (1 x 2) and the
    batch split (2 x 1), against JAX's on a 2 x 4 ("data", "member") mesh
    of 8 devices, the same noise (``test_parallel.py:361,449``)."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import compute_stats
    from probunet_tpu.ops import distributions as jd
    from probunet_tpu.parallel import make_member_mesh, make_parallel_sample_step

    jmodel, params = jax_tiny_model()
    eps = jnp.asarray(inputs["eps_sample"])
    monkeypatch.setattr(jd.DiagGaussian, "rsample",
                        lambda self, key, sample_shape=(): self.mu + self.sigma * eps)
    cfg = _jax_cfg(B, M_SAMPLE, standardization=standardization)
    step = make_parallel_sample_step(jmodel, cfg, make_member_mesh(n_member=4),
                                     num_samples=M_SAMPLE)
    hr = inputs["hr_normal"]
    want = np.asarray(step(jax.tree.map(jnp.asarray, params), hr, jax.random.key(0),
                           compute_stats(jnp.asarray(hr), 4)))
    assert want.shape == (B, M_SAMPLE, 16, 16, 3)
    for n_member in (2, 1):
        name = f"{standardization} member{n_member}"
        _assert_ranks_agree([r[name] for r in runs["member"]])
        got = runs["member"][0][name]
        assert tuple(got.shape) == want.shape
        assert np.isfinite(got.numpy()).all()
        assert_close(got, want, SAMPLE_RTOL, SAMPLE_ATOL, name)


# ---------------------------------------------------------------------------
# Dropout offsets: a slab of the batch drops what the whole batch drops
# ---------------------------------------------------------------------------

def _chain_args(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    x = torch.randn(shape, generator=g)
    return (x, 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn((b, c), generator=g), 0.1 * torch.randn((b, c), generator=g),
            torch.tensor([123456789, -98765], dtype=torch.int32))


@pytest.mark.parametrize("offset", [1, 3])
def test_c_plain_versions_with_a_batch_offset_give_the_global_rows(offset):
    """C's and C′'s plain versions on rows [offset, offset + 2) of a batch of
    5, under the seed words ``slab_seed`` shifts by the offset, return those
    rows of the whole batch's outputs bit for bit; without the shift the
    masks differ. At offset 0 the seed words are the given ones."""
    from probunet_tpu_torch.ops.kernels import fused_gn as tgn

    x, gamma, beta, scale, shift, seed = _chain_args((5, 8, 8, 16))
    consts = (4, 1e-5, 0.3, True)
    y, mean, rstd = tgn.gn_film_silu_dropout_plain(x, gamma, beta, scale, shift, seed, *consts)
    g = torch.randn_like(x)
    grads = tgn.gn_film_silu_dropout_bwd_plain(x, g, gamma, beta, scale, shift, seed, mean, rstd,
                                               4, 0.3, True)
    rows = slice(offset, offset + 2)
    shifted = tgn.slab_seed(seed, offset)
    assert shifted.dtype == torch.int32 and tgn.slab_seed(seed, 0) is seed
    part = (x[rows], gamma, beta, scale[rows], shift[rows], shifted)
    y_s, mean_s, rstd_s = tgn.gn_film_silu_dropout_plain(*part, *consts)
    assert torch.equal(y_s, y[rows]) and torch.equal(mean_s, mean[rows])
    dx, _, _, dscale, dshift = tgn.gn_film_silu_dropout_bwd_plain(
        x[rows], g[rows], *part[1:], mean_s, rstd_s, 4, 0.3, True)
    assert torch.equal(dx, grads[0][rows]) and torch.equal(dscale, grads[3][rows])
    assert torch.equal(tgn.gn_keep((2, 8, 8, 16), shifted, 0.3),
                       tgn.gn_keep((5, 8, 8, 16), seed, 0.3)[rows])
    assert not torch.equal(tgn.gn_keep((2, 8, 8, 16), seed, 0.3), tgn.gn_keep(
        (5, 8, 8, 16), seed, 0.3)[rows])
    # the second seed word wraps: an offset that carries it past 2^31 - 1
    big = torch.tensor([5, 2**31 - 2], dtype=torch.int32)
    assert torch.equal(tgn.gn_keep((1, 8, 8, 16), tgn.slab_seed(big, 4), 0.3),
                       tgn.gn_keep((5, 8, 8, 16), big, 0.3)[4:])
    # the autograd function, under the shifted seed words, in the backward too
    xs = x[rows].clone().requires_grad_(True)
    out = tgn.gn_film_silu_dropout(xs, *part[1:], *consts)
    (out * g[rows]).sum().backward()
    assert torch.equal(out.detach(), y[rows]) and torch.equal(xs.grad, grads[0][rows])


# (slab rows, global rows, per-row elements): the global tensor's block
# height differs from the slab's (32 rows against 16; 2,048 against 8)
D_CASES = [(2, 4, 1024), (3, 8, 4 * 8 * 64)]


@pytest.mark.parametrize("b_local,b_total,per", D_CASES)
def test_d_plain_version_with_an_offset_gives_the_global_rows(b_local, b_total, per):
    """D's plain version (and its autograd function) on a slab of rows, told
    its element offset and the global numel, returns the whole tensor's
    rows bit for bit, for every slab; without them the block height, and
    so the mask, differs."""
    from probunet_tpu_torch.ops.kernels import dropout as tdrop

    x = torch.randn((b_total, per), generator=torch.Generator().manual_seed(1))
    seed = torch.tensor([7, 11], dtype=torch.int32)
    whole = tdrop.dropout(x, seed, 0.25)
    for r0 in range(0, b_total - b_local + 1, b_local):
        rows = slice(r0, r0 + b_local)
        xs = x[rows].clone().requires_grad_(True)
        got = tdrop.dropout(xs, seed, 0.25, r0 * per, b_total * per)
        assert torch.equal(got, whole[rows])
        got.backward(torch.ones_like(got))
        assert torch.equal(xs.grad, (whole[rows] != 0).float() * xs.grad.max())
    whole_keep = tdrop.dropout_keep((b_total, per), seed, 0.25)
    last = b_total - b_local
    assert torch.equal(tdrop.dropout_keep((b_local, per), seed, 0.25, last * per, b_total * per),
                       whole_keep[last:])
    # without the offset, or without the global numel (another block height)
    assert not torch.equal(tdrop.dropout_keep((b_local, per), seed, 0.25), whole_keep[last:])
    assert not torch.equal(tdrop.dropout_keep((b_local, per), seed, 0.25, last * per),
                           whole_keep[last:])


@pytest.mark.parametrize("gn_impl", DROP_ROUTES)
def test_groupnorm_chain_with_a_slab_gives_the_global_rows(gn_impl):
    """``EDMGroupNorm(slab=)`` on each route, at a shape D takes only whole
    (at 16 elements a row, the global batch of 64 rows), at one where
    neither the slab nor the batch is D's (the other-shape hash), and at
    one kernel C takes: the slab's rows of the whole batch's output."""
    from probunet_tpu_torch.models.layers import EDMGroupNorm

    for b, c, h in ((64, 16, 1), (6, 12, 1), (4, 16, 8)):
        gn = EDMGroupNorm(c, gn_impl=gn_impl)
        x = torch.randn((b, c, h, h), generator=torch.Generator().manual_seed(c)).to(
            memory_format=torch.channels_last)
        g = torch.Generator().manual_seed(b)
        film = (0.1 * torch.randn(b, c, generator=g), 0.1 * torch.randn(b, c, generator=g))
        seed = torch.tensor([3, 5], dtype=torch.int32)
        whole = gn(x, silu=True, film=film, drop_p=0.2, drop_seed=seed)
        half = b // 2
        for r0 in (0, half):
            rows = slice(r0, r0 + half)
            got = gn(x[rows], silu=True, film=(film[0][rows], film[1][rows]), drop_p=0.2,
                     drop_seed=seed, slab=(r0, b))
            # the masks bit for bit; the values to f32 rounding (the composed
            # chain's mean over a group may add in another order at another
            # batch size)
            assert torch.equal(got == 0, whole[rows] == 0), (b, c, r0)
            assert_close(got.detach(), whole[rows].detach(), 1e-6, 1e-7, f"{(b, c, r0)}")


# ---------------------------------------------------------------------------
# World of one: meshes, slabs, initialize
# ---------------------------------------------------------------------------

def test_make_mesh_in_a_world_of_one():
    """Without a process group the mesh is a world of one; a mesh the world
    does not hold raises (ValueError, as JAX's), a 1 x 2 spatial mesh
    included, and the WMSE + MS-SSIM loss of a rank's block of rows
    raises without the global batch's data range."""
    from probunet_tpu_torch.ops.losses import wmse_ms_ssim_loss
    from probunet_tpu_torch.parallel import make_mesh
    from probunet_tpu_torch.parallel.member_parallel import make_member_mesh
    from probunet_tpu_torch.parallel.mesh import Mesh
    from probunet_tpu_torch.parallel.spatial import Rows
    from probunet_tpu_torch.parallel.tensor_parallel import make_dp_tp_mesh

    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.is_main and mesh.world_size == 1
    assert mesh.group("data") is None and mesh.group(("data", "spatial")) is None
    with pytest.raises(ValueError):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_data=1, n_spatial=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_spatial=2, device="cpu")
    with pytest.raises(ValueError):
        make_member_mesh(n_member=1, n_spatial=2, device="cpu")
    with pytest.raises(ValueError):
        make_member_mesh(n_member=2, device="cpu")
    assert make_dp_tp_mesh(n_model=1, device="cpu").shape == {"data": 1, "model": 1}
    # a rank's record of a 1 x 2 mesh: a block's range is not the batch's
    rows = Rows(Mesh(shape={"data": 1, "spatial": 2}, coords={"data": 0, "spatial": 1},
                     groups={}), h0=64, height=128)
    x = torch.zeros((2, 64, 128, 3))
    with pytest.raises(ValueError, match="global batch's data_range"):
        wmse_ms_ssim_loss(x, x, rows=rows)


def test_slabs_of_a_global_batch():
    """process_local_indices / batch_sharding / shard_batch give rank i of
    the data axis its contiguous slab, and a batch that does not divide
    raises."""
    from probunet_tpu_torch.parallel.mesh import Mesh, batch_sharding, shard_batch
    from probunet_tpu_torch.parallel.multihost import data_slab, process_local_indices

    idx = np.arange(16)
    np.testing.assert_array_equal(process_local_indices(idx), idx)   # a world of one
    mesh = Mesh(shape={"data": 4, "member": 2}, coords={"data": 2, "member": 1}, groups={},
                device=torch.device("cpu"), rank=5, world_size=8)
    np.testing.assert_array_equal(process_local_indices(idx, mesh), [8, 9, 10, 11])
    assert batch_sharding(mesh, 16) == slice(8, 12) and data_slab(mesh, 4) == (8, 16)
    batch = {"hr": np.arange(32.0).reshape(16, 2), "n": np.float32(3)}
    got = shard_batch(batch, mesh)
    assert torch.equal(got["hr"], torch.arange(16.0, 24.0).reshape(4, 2))
    assert float(got["n"]) == 3.0
    with pytest.raises(ValueError, match="divide"):
        process_local_indices(np.arange(10), mesh)


def test_initialize_without_a_world_stays_one_process(monkeypatch):
    """Without WORLD_SIZE, initialize does nothing; explicit arguments that
    fail raise and leave no process group."""
    import torch.distributed as dist

    from probunet_tpu_torch.parallel import initialize

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="rendezvous"):
        initialize(device="cpu", init_method="nosuch://host:1", world_size=1, rank=0)
    assert not dist.is_initialized()


def test_a_world_of_one_under_a_process_group_runs_no_collective(tmp_path):
    """A world of one started under torch.distributed (as torchrun starts
    ``--dp 1``): its axis of size 1 has no group, so the gradients come
    back from ``mean_over`` untouched, with no all-reduce."""
    import torch.distributed as dist

    from probunet_tpu_torch.parallel import initialize, make_mesh
    from probunet_tpu_torch.parallel.mesh import mean_over

    initialize(device="cpu", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
               rank=0)
    try:
        mesh = make_mesh(device="cpu")
        assert dist.is_initialized() and mesh.group("data") is None
        grads = [torch.ones(2, 3)]
        assert mean_over(grads, mesh) is grads
    finally:
        dist.destroy_process_group()


def test_replicate_global_in_a_world_of_one():
    from probunet_tpu_torch.parallel import make_mesh, replicate_global

    mesh = make_mesh(device="cpu")
    tree = {"w": np.ones((2, 3), np.float32), "b": [torch.zeros(2)], "name": "x"}
    got = replicate_global(tree, mesh)
    assert torch.equal(got["w"], torch.ones(2, 3)) and got["name"] == "x"
    assert math.isclose(float(got["b"][0].sum()), 0.0)
