"""Data-parallel train and eval steps (port of
``probunet_tpu/parallel/data_parallel.py``).

Each rank runs the port's own ELBO step, ``train.loop.make_train_step``
(or ``make_eval_step``) with ``mesh=``, on its contiguous slab of the
global batch, and the step equals the single-process step on the whole
batch (JAX ``tests/test_parallel.py:83``):

- **Global draws.** The step's generator (``train.state.step_generator``)
  is seeded alike on every rank; the U-Net draws its dropout seed words
  from it as before, and ``ProbabilisticUNet.elbo(slab=)`` draws the
  posterior noise at the global batch's shape, in the single-process
  order, each rank keeping its rows.
- **Global masks.** The rank's slab enters the U-Net as ``slab`` = (first
  row, global batch): kernels C/C′ take seed words shifted by the first
  row (``fused_gn.slab_seed``) and kernel D hashes the global element
  index with the global tensor's block height, so every rank drops what
  the single-process step drops.
- **One all-reduce.** After the backward, the gradients are averaged over
  the "data" axis by one fixed-order all-reduce of one flat f32 buffer in
  parameter order (``mesh.mean_over``), then AdamW runs on the same
  replicated state on every rank (``grad_clip`` and the reported
  ``grad_norm`` see the averaged gradients). No DDP: this works with the
  remat modes and the kernels' autograd functions, and a run is
  reproducible.
- **Global metrics.** ``loss``, ``recon``, ``kl_mean`` (and each loss's own
  metrics) are means over the global batch: the ranks' means averaged by
  one more all-reduce.

A mesh with n_spatial > 1 shards each image's rows as well (JAX's
P("data", "spatial", None, None)): the rank's input is its block of rows
of its slab, and the step threads a ``parallel.spatial.Rows`` record
through the model, which halo-exchanges every convolution, all-reduces
every statistic that crosses rows (GroupNorm's sums around the split
kernels C/C′, the encoders' pool, the CRPS terms of kernels A/A′ or
B/B′: the counterpart of ``ops/pallas/partition.py``'s ``psum``) and
keeps the masks of the global rows. The gradients are then averaged over
("data", "spatial") (the convention in ``parallel/spatial.py``).
"""

from __future__ import annotations

from typing import Callable

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.parallel.mesh import SPATIAL_AXIS, Mesh
from probunet_tpu_torch.train.loop import make_eval_step, make_train_step


def _sharded(mesh: Mesh, spatial: bool | None) -> Mesh:
    """``mesh``, after checking ``spatial`` against it: the rows are split
    exactly where the mesh's "spatial" axis is larger than 1 (JAX's default,
    ``data_parallel.py:57-58``); replicas over that axis raise."""
    if spatial is False and mesh.size(SPATIAL_AXIS) > 1:
        raise ValueError("spatial=False on a mesh with n_spatial > 1 would replicate the step "
                         "over that axis; build the mesh with n_spatial=1")
    return mesh


def make_parallel_train_step(model: ProbabilisticUNet, cfg: Config, mesh: Mesh,
                             fused: bool = True, spatial: bool | None = None) -> Callable:
    """The data-parallel ELBO train step over ``mesh``'s "data" axis,
    ``make_train_step(..., mesh=mesh)``:

        step(state, hr_slab, stats, beta_0, beta_1[, eps, seeds])
            -> (state, {"loss", "recon", "kl_mean", "grad_norm", ...})

    ``hr_slab`` is this rank's rows of the global batch (its
    ``process_local_indices``), on the state's device, and with n_spatial >
    1 its block of rows (``shard_batch``); ``eps`` is the global batch's
    noise."""
    return make_train_step(model, cfg, fused=fused, mesh=_sharded(mesh, spatial))


def make_parallel_eval_step(model: ProbabilisticUNet, cfg: Config, mesh: Mesh,
                            fused: bool = True, spatial: bool | None = None,
                            quant: dict | None = None) -> Callable:
    """The data-parallel no-grad ELBO, ``make_eval_step(..., mesh=mesh)``:
    step(hr_slab, stats, generator) -> the global batch's {"recon",
    "kl_mean", "loss"} on every rank."""
    return make_eval_step(model, cfg, fused=fused, quant=quant, mesh=_sharded(mesh, spatial))
