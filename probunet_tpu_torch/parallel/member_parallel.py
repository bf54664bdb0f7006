"""Ensemble-member parallelism for the serve path (port of
``probunet_tpu/parallel/member_parallel.py``).

A ("data", "member") mesh splits the prior ensemble of a batch: each rank
encodes its "data" slab of the batch once (the U-Net's features carry no
member axis), decodes its "member" slice of the global noise through
Fcomb, and brings the decoded residuals to HR units with per-item
statistics. With ``n_spatial > 1`` the mesh is ("data", "spatial",
"member"), JAX's layout for one program over batch, image rows and
members: each rank preprocesses and encodes its block of image rows (the
U-Net and the encoders on the block, halo-exchanged and with the
encoders' pool summed over "spatial", ``parallel/spatial.py``), decodes its
member slice and brings its rows to HR units. The ranks' blocks are then
all-gathered and laid out in data, member and row order, so every rank
returns the (B, M, H, W, C) ensemble the single-process
``ProbabilisticUNet.sample`` + ``residual_to_hr`` path gives on the same
noise. Members are independent given the features: the member split
changes no arithmetic but the batch each convolution sees.
"""

from __future__ import annotations

from typing import Callable

import torch

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.data.climex import (
    Standardization,
    lrinterp_from_batch,
    preprocess_batch,
    residual_to_hr,
    stats_rows,
)
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.ops.quantize import attached
from probunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MEMBER_AXIS,
    SPATIAL_AXIS,
    Mesh,
    all_gather,
    mesh_of,
    row_sharding,
    world,
)
from probunet_tpu_torch.parallel.spatial import check_block, rows_of


def make_member_mesh(n_data: int | None = None, n_member: int = 1,
                     device: str | torch.device | None = None, n_spatial: int = 1) -> Mesh:
    """A ("data", "member") mesh over the world's ranks (the member axis
    varies fastest); ``n_spatial > 1`` inserts a "spatial" axis:
    ("data", "spatial", "member"). ``n_data=None`` takes the world size
    over ``n_member * n_spatial``."""
    _, n = world()
    if n_data is None:
        if n % (n_member * n_spatial):
            raise ValueError(f"{n} ranks not divisible by n_member*n_spatial="
                             f"{n_member * n_spatial}")
        n_data = n // (n_member * n_spatial)
    sizes = {DATA_AXIS: n_data, MEMBER_AXIS: n_member}
    if n_spatial > 1:
        sizes[SPATIAL_AXIS] = n_spatial
    return mesh_of(sizes, device)


def _part(n: int, parts: int, i: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} of {n} does not divide over {parts} ranks")
    per = n // parts
    return slice(i * per, (i + 1) * per)


def make_parallel_sample_step(model: ProbabilisticUNet, cfg: Config, mesh: Mesh,
                              num_samples: int = 16, quant: dict | None = None) -> Callable:
    """Member- and data-sharded prior-ensemble generation over ``mesh``:

        step(hr_batch, eps, stats) -> HR-units ensemble (B, M, H, W, C)

    ``hr_batch`` is the global raw batch (B, H, W, C) on the rank's device
    (each rank keeps its "data" slab of it, and with n_spatial > 1 its
    block of image rows), ``eps`` the global noise (M, B, D) alike on
    every rank (``cli.batch_noise``; the rank decodes its "member" slice of
    its rows), ``stats`` the replicated statistics. Every rank returns the
    whole ensemble in data, member and row order. ``quant``: a calibrated
    scales tree (rank 0's, broadcast): the rank's convolutions serve int8
    through kernel E (on the halo-padded blocks of rows)."""
    d = cfg.data
    eps_members = num_samples
    levels = max(len(cfg.model.channel_mult), len(cfg.model.num_filters))

    @torch.no_grad()
    def step(hr_batch: torch.Tensor, eps: torch.Tensor, stats: Standardization) -> torch.Tensor:
        b = hr_batch.shape[0]
        if tuple(eps.shape[:2]) != (eps_members, b):
            raise ValueError(f"eps {tuple(eps.shape)} is not (M={eps_members}, B={b}, D)")
        items = _part(b, mesh.size(DATA_AXIS), mesh.coord(DATA_AXIS), "a batch")
        members = _part(eps_members, mesh.size(MEMBER_AXIS), mesh.coord(MEMBER_AXIS),
                        "an ensemble")
        block = hr_batch[items][:, row_sharding(mesh, hr_batch.shape[1])].contiguous()
        rows = rows_of(mesh, block.shape[1])
        if rows is not None:
            check_block(block.shape[1], d.lowres_scale, levels)
        batch = preprocess_batch(block, stats, d.pipeline, d.lowres_scale, d.interp_mode,
                                 d.epsilon, d.standardization, rows)
        x = batch["inputs"]
        with attached(model, quant):
            feats, prior, _ = model.encode(x, rows=rows)
            zs = prior.rsample(None, (members.stop - members.start,),
                               eps[members, items].to(x.device))
            out = model.decode(feats, zs)                          # (b, m, h, W, C)
        lrinterp = lrinterp_from_batch(batch, d.lowres_scale, d.interp_mode, rows)
        ist = batch.get("stand_stats")
        if ist is not None:  # the member axis of (B, M, ...) outputs
            ist = {k: v[:, None] for k, v in ist.items()}
        if rows is not None:   # the per-pixel statistics of the block's rows
            stats = stats_rows(stats, rows.h0, block.shape[1], d.lowres_scale)
        hr = residual_to_hr(out, lrinterp[:, None], stats, d.pipeline, d.epsilon,
                            d.standardization, item_stats=ist)
        blocks = all_gather(hr.contiguous(), mesh)                 # rank order
        # ranks are row-major over (data, spatial, member): regroup
        n_member, n_rows = mesh.size(MEMBER_AXIS), mesh.size(SPATIAL_AXIS)
        per_item = n_member * n_rows
        return torch.cat([
            torch.cat([torch.cat(blocks[i + r * n_member:i + (r + 1) * n_member], dim=1)
                       for r in range(n_rows)], dim=2)
            for i in range(0, len(blocks), per_item)], dim=0)

    return step
