"""Multi-process runtime helpers (port of ``probunet_tpu/parallel/multihost.py``).

- :func:`initialize` — ``torch.distributed.init_process_group`` from the
  environment ``torchrun`` sets (no-op without ``WORLD_SIZE``, or when a
  group is up already); explicit keyword arguments that fail raise, as
  ``jax.distributed.initialize``'s do;
- :func:`rank_device` — the device of this rank (``cuda:LOCAL_RANK``);
- :func:`process_local_indices` — which rows of a global batch this rank
  loads: its contiguous slab over the mesh's "data" axis;
- :func:`global_batch` — that slab as a tensor on the rank's device (the
  port's processes hold their own slabs, so nothing is assembled);
- :func:`replicate_global` — values every rank already holds alike, checked
  against rank 0's by a broadcast.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from probunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    batch_sharding,
    broadcast_,
    world,
)

TIMEOUT = timedelta(minutes=10)


def default_backend(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(device: str | torch.device | None = None, **kwargs) -> None:
    """Start ``torch.distributed`` for this process (no-op if a group is up).

    With no keyword arguments the world comes from the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) and the call does nothing without
    ``WORLD_SIZE``: the run stays a world of one. Keyword arguments go to
    ``init_process_group`` as given (``init_method``, ``world_size``,
    ``rank``, ``backend``), and a failure raises: a misconfigured world must
    not fall back to one process. The backend follows ``device`` (NCCL on a
    card, gloo on the CPU; by default the card) unless ``backend`` is
    given. On a card the rank's device becomes the current one."""
    if dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    if not kwargs and "WORLD_SIZE" not in os.environ:
        return
    kwargs.setdefault("backend", default_backend(dev))
    kwargs.setdefault("timeout", TIMEOUT)
    if not kwargs.keys() & {"init_method", "store"}:
        kwargs["init_method"] = "env://"
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev))
    dist.init_process_group(**kwargs)


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: on a card ``cuda:LOCAL_RANK`` (modulo the cards
    present; ``cuda:0`` without ``LOCAL_RANK``), else ``device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def replicate_global(tree, mesh: Mesh):
    """``tree`` (a tensor, array, or dict/list/tuple of them; other leaves
    kept) on the rank's device, after checking that every rank holds rank
    0's values: each leaf is broadcast from rank 0 and compared with the
    rank's own. The values must be alike already (same seeds, same init):
    a rank that differs raises."""
    if isinstance(tree, dict):
        return {k: replicate_global(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [replicate_global(v, mesh) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if not isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree
    mine = torch.as_tensor(tree).to(mesh.device)
    theirs = broadcast_(mine.clone(), mesh)
    if not torch.equal(theirs, mine):
        raise ValueError(f"replicate_global: rank {mesh.rank} holds other values than rank 0 "
                         f"(a leaf of shape {tuple(mine.shape)})")
    return mine


def process_local_indices(global_indices: np.ndarray, mesh: Mesh | None = None) -> np.ndarray:
    """The contiguous slab of a global batch's indices this rank loads: its
    part over the mesh's "data" axis (over the world's ranks without a
    mesh). Raises when the batch does not divide."""
    if mesh is None:
        rank, n = world()
        if len(global_indices) % n:
            raise ValueError(f"a batch of {len(global_indices)} does not divide over {n} ranks")
        per = len(global_indices) // n
        return global_indices[rank * per:(rank + 1) * per]
    return global_indices[batch_sharding(mesh, len(global_indices))]


def global_batch(local_batch, mesh: Mesh) -> torch.Tensor:
    """This rank's slab (:func:`process_local_indices` of a global batch) as
    a tensor on its device, the batch the data-parallel steps take."""
    return torch.as_tensor(local_batch).to(mesh.device)


def data_slab(mesh: Mesh, local_rows: int) -> tuple[int, int]:
    """(first row, global batch) of a rank's slab of ``local_rows`` rows."""
    return mesh.coord(DATA_AXIS) * local_rows, mesh.size(DATA_AXIS) * local_rows
