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

There is no counterpart of ``ops/pallas/partition.py``: each rank launches
kernels A/A′ (or B/B′) on its own rows. The spatially sharded step (a mesh
with n_spatial > 1) is not ported (``mesh.SPATIAL_NOT_PORTED``).
"""

from __future__ import annotations

from typing import Callable

from probunet_tpu_torch.config import Config
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
from probunet_tpu_torch.parallel.mesh import SPATIAL_NOT_PORTED, Mesh
from probunet_tpu_torch.train.loop import make_eval_step, make_train_step


def make_parallel_train_step(model: ProbabilisticUNet, cfg: Config, mesh: Mesh,
                             fused: bool = True, spatial: bool | None = None) -> Callable:
    """The data-parallel ELBO train step over ``mesh``'s "data" axis,
    ``make_train_step(..., mesh=mesh)``:

        step(state, hr_slab, stats, beta_0, beta_1[, eps, seeds])
            -> (state, {"loss", "recon", "kl_mean", "grad_norm", ...})

    ``hr_slab`` is this rank's rows of the global batch (its
    ``process_local_indices``), on the state's device; ``eps`` is the
    global batch's noise."""
    if spatial:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    return make_train_step(model, cfg, fused=fused, mesh=mesh)


def make_parallel_eval_step(model: ProbabilisticUNet, cfg: Config, mesh: Mesh,
                            fused: bool = True, spatial: bool | None = None,
                            quant: dict | None = None) -> Callable:
    """The data-parallel no-grad ELBO, ``make_eval_step(..., mesh=mesh)``:
    step(hr_slab, stats, generator) -> the global batch's {"recon",
    "kl_mean", "loss"} on every rank."""
    if spatial:
        raise NotImplementedError(SPATIAL_NOT_PORTED)
    return make_eval_step(model, cfg, fused=fused, quant=quant, mesh=mesh)
