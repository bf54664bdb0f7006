"""Parallel paths of the port (port of ``probunet_tpu/parallel``) over
``torch.distributed``: one process per rank, a :class:`mesh.Mesh` a set of
ranks with named axes, explicit collectives (NCCL on cards, gloo on the
CPU).

- :mod:`mesh` — meshes, a rank's slab of a global batch, the collectives;
- :mod:`multihost` — ``init_process_group`` from the environment, each
  rank's rows and device, values checked alike on every rank;
- :mod:`data_parallel` — JAX's names for ``train.loop``'s ELBO train
  and eval steps with ``mesh=``: each rank's slab (and, with n_spatial >
  1, its block of rows) with the global draws and masks, one gradient
  all-reduce;
- :mod:`member_parallel` — the prior ensemble split over ("data",
  "spatial", "member"), gathered in data, member and row order;
- :mod:`spatial` — a rank's block of rows (``Rows``), the differentiable
  halo exchange and sum over "spatial", and the full-domain tiling, its
  tile chunks split over "data";
- :mod:`tensor_parallel` — a channel-sharded convolution pair with one
  all-reduce over "model".

Under n_spatial > 1 the MS-SSIM and L1 ELBOs, the ``lr_*`` pipelines and
bilinear interpolation raise, naming their ROADMAP.md item.
"""

from probunet_tpu_torch.parallel.data_parallel import (
    make_parallel_eval_step,
    make_parallel_train_step,
)
from probunet_tpu_torch.parallel.member_parallel import (
    make_member_mesh,
    make_parallel_sample_step,
)
from probunet_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    row_sharding,
    shard_batch,
)
from probunet_tpu_torch.parallel.multihost import (
    global_batch,
    initialize,
    process_local_indices,
    replicate_global,
)
from probunet_tpu_torch.parallel.spatial import (
    Rows,
    extract_tiles,
    halo_conv2d,
    halo_exchange,
    stitch_tiles,
    sum_over,
    tiled_ensemble,
)
from probunet_tpu_torch.parallel.tensor_parallel import (
    channel_sharded_block,
    init_channel_sharded_params,
    make_channel_sharded_apply,
    make_dp_tp_mesh,
    shard_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "row_sharding",
    "shard_batch",
    "make_parallel_train_step",
    "make_parallel_eval_step",
    "make_member_mesh",
    "make_parallel_sample_step",
    "Rows",
    "halo_exchange",
    "halo_conv2d",
    "sum_over",
    "extract_tiles",
    "stitch_tiles",
    "tiled_ensemble",
    "initialize",
    "global_batch",
    "process_local_indices",
    "replicate_global",
    "make_dp_tp_mesh",
    "init_channel_sharded_params",
    "shard_params",
    "channel_sharded_block",
    "make_channel_sharded_apply",
]
