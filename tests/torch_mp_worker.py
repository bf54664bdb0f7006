"""One rank of the parallel-path tests (spawned by ``tests/torch_mp.py``).

    python tests/torch_mp_worker.py WORKDIR JOB[,JOB...]

The rank joins the gloo process group from ``torchrun``'s environment
(``multihost.initialize``), then runs each job: ``JOB.in.pt`` in WORKDIR
holds its inputs (written by the test, numpy or torch values, no JAX), and
the rank writes ``JOB.rank<R>.pt``. It imports torch and the port only, as
a rank started by ``torchrun`` would.
"""

import os
import sys

import torch

from probunet_tpu_torch.parallel import multihost
from probunet_tpu_torch.parallel.mesh import all_gather, mesh_of, world

from torch_mp import tiny_cfg

RANK = int(os.environ.get("RANK", "0"))


def _load(workdir, job):
    return torch.load(os.path.join(workdir, f"{job}.in.pt"), weights_only=False)


def _save(workdir, job, out):
    torch.save(out, os.path.join(workdir, f"{job}.rank{RANK}.pt"))


def dp_step(workdir, job):
    """make_parallel_train_step over ("data" = world), each case's steps
    (``act_compress``: the model's int8 saved convolution inputs;
    ``absmax_per_rank``: with each rank's own absmax, a planted fault)."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch
    from probunet_tpu_torch.train.state import create_train_state

    from probunet_tpu_torch.ops import act_compress

    inp = _load(workdir, job)
    out = {}
    quantize = act_compress.quantize_channels
    for case in inp["cases"]:
        cfg = tiny_cfg(case["hr"].shape[0], case["m"])
        model = torch_tiny_model(inp["params"], dropout=case["dropout"],
                                 gn_impl=case["gn_impl"],
                                 act_compress=case.get("act_compress", False))
        if case.get("absmax_per_rank"):   # a planted fault: each slab's own absmax
            act_compress.quantize_channels = lambda xn, mesh=None: quantize(xn)
        state = create_train_state(model, seed=cfg.train.seed, device="cpu")
        mesh = make_mesh(device="cpu")
        hr = torch.from_numpy(case["hr"])
        stats = compute_stats(hr, cfg.data.lowres_scale)
        step = make_parallel_train_step(model, cfg, mesh, fused=case["fused"])
        eps = None if case["eps"] is None else torch.from_numpy(case["eps"])
        metrics = []
        for _ in range(case["steps"]):
            state, met = step(state, shard_batch(hr, mesh), stats, 1.0, 0.1, eps=eps)
            metrics.append({k: v.numpy().copy() for k, v in met.items()})
        act_compress.quantize_channels = quantize
        out[case["name"]] = {"metrics": metrics, "params": {
            k: v.detach().clone() for k, v in model.state_dict().items()}}
    _save(workdir, job, out)


def trainer(workdir, job):
    """Trainer(mesh=make_mesh()).fit over the given splits."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.parallel import make_mesh
    from probunet_tpu_torch.train.checkpoint import CheckpointManager
    from probunet_tpu_torch.train.logging import MetricLogger
    from probunet_tpu_torch.train.loop import Trainer

    inp = _load(workdir, job)
    cfg = tiny_cfg(inp["batch"], inp["m"])
    kw = dict(variables=cfg.data.variables, pipeline=cfg.data.pipeline,
              lowres_scale=cfg.data.lowres_scale, device="cpu")
    ds_train, ds_val = (ClimexDataset(hr=inp[k], **kw) for k in ("train", "val"))
    run = os.path.join(workdir, "trainer")
    logger = MetricLogger(run, stdout=False)
    ckpt = CheckpointManager(os.path.join(run, "ckpt"))
    t = Trainer(cfg, torch_tiny_model(inp["params"], dropout=inp["dropout"]), ds_train, ds_val,
                logger=logger, checkpoint_manager=ckpt, mesh=make_mesh(device="cpu"))
    hist = t.fit(inp["epochs"])
    _save(workdir, job, {"history": hist, "step": t.state.step, "logged": len(logger.history)})


def member(workdir, job):
    """make_parallel_sample_step on each member-mesh shape and config."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import Standardization
    from probunet_tpu_torch.parallel import make_member_mesh, make_parallel_sample_step

    inp = _load(workdir, job)
    model = torch_tiny_model(inp["params"])
    out = {}
    for case in inp["cases"]:
        cfg = tiny_cfg(case["hr"].shape[0], case["eps"].shape[0],
                        standardization=case["standardization"])
        stats = Standardization(*(None if a is None else torch.from_numpy(a)
                                  for a in case["stats"]))
        mesh = make_member_mesh(n_member=case["n_member"], device="cpu")
        step = make_parallel_sample_step(model, cfg, mesh, num_samples=case["eps"].shape[0])
        out[case["name"]] = step(torch.from_numpy(case["hr"]), torch.from_numpy(case["eps"]),
                                 stats)
    _save(workdir, job, out)


def halo(workdir, job):
    """halo_conv2d of each rank's rows over a ("spatial" = world) mesh,
    gathered."""
    from probunet_tpu_torch.parallel import halo_conv2d

    inp = _load(workdir, job)
    mesh = mesh_of({"spatial": world()[1]}, device="cpu")
    out = {}
    for name, (x, w) in inp.items():
        rows = torch.from_numpy(x).chunk(mesh.size("spatial"), dim=1)[mesh.coord("spatial")]
        mine = halo_conv2d(rows, torch.from_numpy(w), mesh)
        out[name] = torch.cat(all_gather(mine.contiguous(), mesh, "spatial"), dim=1)
    _save(workdir, job, out)


def tiled(workdir, job):
    """tiled_ensemble(mesh=make_mesh()) of a linear sampler and of one that
    reads the chunk start and the rows it was given."""
    from probunet_tpu_torch.parallel import make_mesh, tiled_ensemble

    inp = _load(workdir, job)
    mesh = make_mesh(device="cpu")
    field = torch.from_numpy(inp["field"])

    def linear(tiles, start, rows=None):
        return 2.0 * tiles[:, None]

    def indexed(tiles, start, rows=None):
        idx = torch.arange(tiles.shape[0]) if rows is None else torch.from_numpy(rows)
        return (tiles + (start + idx).float()[:, None, None, None])[:, None]

    out = {"linear": tiled_ensemble(linear, field, 32, 8, mesh=mesh),
           "indexed": tiled_ensemble(indexed, field, 32, 8, batch_tiles=inp["batch_tiles"],
                                     mesh=mesh)}
    _save(workdir, job, out)


def tensor_parallel(workdir, job):
    """The channel-sharded pair on ("data", "model") meshes, gathered."""
    from probunet_tpu_torch.parallel import make_channel_sharded_apply, make_dp_tp_mesh
    from probunet_tpu_torch.parallel import shard_params

    inp = _load(workdir, job)
    x = torch.from_numpy(inp["x"])
    out = {}
    for n_model in (world()[1], 1):
        mesh = make_dp_tp_mesh(n_model=n_model, device="cpu")
        local = shard_params(inp["params"], mesh)
        mine = make_channel_sharded_apply(mesh)(local, x)
        out[f"model{n_model}"] = {"out": torch.cat(all_gather(mine, mesh, "data")),
                                  "w1_shard": tuple(local["w1"].shape)}
    _save(workdir, job, out)


def cli(workdir, job):
    """``cli.main`` on each argv (the command's result, or the exception
    type and message it raised)."""
    from probunet_tpu_torch import cli as tcli

    out = []
    for argv in _load(workdir, job):
        try:
            res, _ = tcli.main(argv)
            out.append({"result": res})
        except (ValueError, SystemExit) as e:
            out.append({"raised": type(e).__name__, "message": str(e)})
    _save(workdir, job, out)


def spatial_step(workdir, job):
    """The train (or eval) step on each case's ("data", "spatial") mesh:
    every case's steps on the rank's block of rows, the first from a fresh
    state; ``starts``: for each step, the saved state it starts from
    (:func:`train_state_of`), or None to go on from the previous step
    (``act_compress``: the model's int8 saved convolution inputs)."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import compute_stats
    from probunet_tpu_torch.parallel import (make_mesh, make_parallel_eval_step,
                                             make_parallel_train_step, shard_batch)
    from probunet_tpu_torch.train.state import create_train_state

    inp = _load(workdir, job)
    out = {}
    for case in inp["cases"]:
        hr = torch.from_numpy(case["hr"])
        cfg = tiny_cfg(hr.shape[0], case["m"], resolution=tuple(hr.shape[1:3]),
                       **case.get("data", {}))
        for k, v in case.get("loss", {}).items():
            setattr(cfg.loss, k, v)
        model = torch_tiny_model(case.get("params", inp["params"]), dropout=case["dropout"],
                                 gn_impl=case["gn_impl"], remat=case.get("remat", False),
                                 num_filters=case.get("num_filters", (8, 16)),
                                 img_resolution=tuple(hr.shape[1:3]),
                                 act_compress=case.get("act_compress", False))
        mesh = make_mesh(case["n_data"], case["n_spatial"], device="cpu")
        stats = compute_stats(hr, cfg.data.lowres_scale)
        block = shard_batch(hr, mesh)
        if case.get("eval"):
            step = make_parallel_eval_step(model, cfg, mesh, fused=case["fused"])
            met = step(block, stats, torch.Generator().manual_seed(3))
            out[case["name"]] = {"metrics": [{k: v.numpy().copy() for k, v in met.items()}]}
            continue
        state = create_train_state(model, seed=cfg.train.seed, device="cpu")
        grads = captured_grads(state)
        step = make_parallel_train_step(model, cfg, mesh, fused=case["fused"])
        eps = None if case["eps"] is None else torch.from_numpy(case["eps"])
        metrics = []
        starts = case.get("starts") or [None] * case["steps"]
        for start in starts:
            if start is not None:
                load_train_state(state, start)
            state, met = step(state, block, stats, 1.0, 0.1, eps=eps)
            metrics.append({k: v.numpy().copy() for k, v in met.items()})
        out[case["name"]] = {"metrics": metrics, "grads": grads, "params": {
            k: v.detach().clone() for k, v in model.state_dict().items()}}
    _save(workdir, job, out)


def int8_convs() -> dict:
    """Two 3x3 EDMConvs of 3 (and 3 + 3) input channels with int8 scales
    attached: kernel E's route for one and for two inputs."""
    from probunet_tpu_torch.models.layers import EDMConv

    out = {}
    for name, cin in (("one", 3), ("two", 6)):
        conv = EDMConv(cin, 5, 3, generator=torch.Generator().manual_seed(cin))
        conv.quant_scales = {"in_scale": torch.tensor(0.02), "in_scale2": torch.tensor(0.015)}
        out[name] = conv
    return out


def captured_grads(state) -> list:
    """A list that gets the gradients each ``state.optimizer.step`` call
    receives (copies), the call going on as before."""
    seen, step = [], state.optimizer.step

    def capture(grads):
        seen.append([g.detach().clone() for g in grads])
        return step(grads)

    state.optimizer.step = capture
    return seen


def train_state_of(state) -> dict:
    """A copy of a train state: the model's parameters and buffers, the
    AdamW moments and count, and the step count."""
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def load_train_state(state, saved: dict) -> None:
    """Set a train state to one saved by :func:`train_state_of`."""
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]


def spatial_member(workdir, job):
    """make_parallel_sample_step on each case's ("data", "spatial",
    "member") mesh."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import Standardization
    from probunet_tpu_torch.parallel import make_member_mesh, make_parallel_sample_step

    inp = _load(workdir, job)
    out = {}
    for case in inp["cases"]:
        hr = torch.from_numpy(case["hr"])
        model = torch_tiny_model(inp["params"], img_resolution=tuple(hr.shape[1:3]))
        cfg = tiny_cfg(hr.shape[0], case["eps"].shape[0], resolution=tuple(hr.shape[1:3]),
                       standardization=case["standardization"], **case.get("data", {}))
        stats = Standardization(*(None if a is None else torch.from_numpy(a)
                                  for a in case["stats"]))
        mesh = make_member_mesh(n_member=case["n_member"], n_spatial=case["n_spatial"],
                                device="cpu")
        step = make_parallel_sample_step(model, cfg, mesh, num_samples=case["eps"].shape[0],
                                         quant=case.get("quant"))
        out[case["name"]] = step(hr, torch.from_numpy(case["eps"]), stats)
    _save(workdir, job, out)


def spatial_ops(workdir, job):
    """The differentiable halo exchange and sum over a ("spatial" = world)
    mesh, the partitioned CRPS terms and the deferred options: values and
    gradients of each rank's block, gathered."""
    from probunet_tpu_torch.ops.losses import afcrps_loss, crps_loss
    from probunet_tpu_torch.parallel import make_mesh
    from probunet_tpu_torch.parallel.spatial import halo_exchange, rows_of, sum_over

    inp = _load(workdir, job)
    mesh = make_mesh(1, world()[1], device="cpu")
    n, pos = mesh.size("spatial"), mesh.coord("spatial")
    out = {}

    def gathered(t, dim):
        return torch.cat(all_gather(t.contiguous(), mesh, "spatial"), dim=dim)

    x = torch.from_numpy(inp["x"]).chunk(n, dim=1)[pos].clone().requires_grad_(True)
    for halo in (1, 2):
        y = halo_exchange(x, halo, mesh)
        # a loss of every padded row, weighted so each row's gradient differs
        w = torch.from_numpy(inp[f"w{halo}"]).chunk(n, dim=1)[pos]
        (y * w).sum().backward()
        out[f"halo{halo}"] = {"y": gathered(y.detach(), 1), "grad": gathered(x.grad, 1)}
        x.grad = None
    s = sum_over(x, mesh)
    (s * torch.from_numpy(inp["ws"])[pos]).sum().backward()
    out["sum"] = {"y": s.detach(), "grad": gathered(x.grad, 1)}
    rows = rows_of(mesh, x.shape[1])
    # kernel E's plain version on halo-padded blocks, one and two inputs
    blk = x.detach().permute(0, 3, 1, 2)
    for name, conv in int8_convs().items():
        with torch.no_grad():
            y = conv(blk, blk * -0.5 if name == "two" else None, rows=rows)
        out[f"int8 {name}"] = gathered(y.permute(0, 2, 3, 1), 1)
    for name, fn in (("afcrps", afcrps_loss), ("crps", crps_loss)):
        ens = torch.from_numpy(inp["ens"]).chunk(n, dim=2)[pos].clone().requires_grad_(True)
        tgt = torch.from_numpy(inp["tgt"]).chunk(n, dim=1)[pos].clone().requires_grad_(True)
        v = fn(ens, tgt, rows=rows)
        # each rank differentiates the replicated loss; the mean over the
        # axis is the convention's gradient
        v.backward()
        out[name] = {"value": v.detach(), "grad_ens": gathered(ens.grad / n, 2),
                     "grad_tgt": gathered(tgt.grad / n, 1)}
    _save(workdir, job, out)


def spatial_losses(workdir, job):
    """On a ("data" = 1, "spatial" = world) mesh: ``ms_ssim`` of the rank's
    block (its value and x's gradient, gathered); ``preprocess_batch`` of
    the rank's block under bilinear interpolation for each pipeline and
    standardization (gathered); and the train step under an ``lr_*``
    pipeline (the type of what it raises)."""
    from torch_parity import torch_tiny_model

    from probunet_tpu_torch.data.climex import Standardization, compute_stats, preprocess_batch
    from probunet_tpu_torch.ops.msssim import ms_ssim
    from probunet_tpu_torch.parallel import make_mesh, make_parallel_train_step, shard_batch
    from probunet_tpu_torch.parallel.spatial import rows_of
    from probunet_tpu_torch.train.state import create_train_state

    inp = _load(workdir, job)
    mesh = make_mesh(1, world()[1], device="cpu")
    n, pos = mesh.size("spatial"), mesh.coord("spatial")
    out = {}

    def gathered(t, dim=1):
        return torch.cat(all_gather(t.contiguous(), mesh, "spatial"), dim=dim)

    x, y = (torch.from_numpy(inp[k]).chunk(n, dim=1)[pos].clone() for k in ("x", "y"))
    x.requires_grad_(True)
    rows = rows_of(mesh, x.shape[1])
    v = ms_ssim(x, y, torch.tensor(inp["data_range"]), win_size=7, rows=rows)
    v.backward()   # of the replicated value: the mean over the axis is the gradient
    out["ms_ssim"] = {"value": v.detach(), "grad": gathered(x.grad / n)}
    hr = torch.from_numpy(inp["hr"])
    block = shard_batch(hr, mesh)
    stats = Standardization(*(torch.from_numpy(a) for a in inp["stats"]))
    for pipeline, standardization in inp["preprocess"]:
        got = preprocess_batch(block, stats, pipeline, 4, "bilinear", 1e-10, standardization,
                               rows_of(mesh, block.shape[1]))
        out[f"{pipeline} {standardization}"] = {
            k: gathered(got[k]) for k in ("inputs", "targets", "lrinterp") if k in got}
    cfg = tiny_cfg(hr.shape[0], 2, resolution=tuple(hr.shape[1:3]), pipeline="lr_to_residuals")
    model = torch_tiny_model(inp["params"], img_resolution=tuple(hr.shape[1:3]))
    state = create_train_state(model, seed=cfg.train.seed, device="cpu")
    try:
        make_parallel_train_step(model, cfg, mesh)(state, block, compute_stats(hr, 4), 1.0,
                                                   0.1)
        out["lr step"] = None
    except (RuntimeError, TypeError, ValueError) as e:
        out["lr step"] = type(e).__name__
    _save(workdir, job, out)


JOBS = {f.__name__: f for f in (dp_step, trainer, member, halo, tiled, tensor_parallel, cli,
                                spatial_step, spatial_member, spatial_ops, spatial_losses)}


def main():
    workdir, jobs = sys.argv[1], sys.argv[2].split(",")
    torch.set_num_threads(1)
    multihost.initialize(device="cpu")
    for job in jobs:
        JOBS[job](workdir, job)
    print(f"MP_OK rank={RANK}", flush=True)


if __name__ == "__main__":
    main()
