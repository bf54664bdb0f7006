"""Meshes of ranks and their collectives (port of
``probunet_tpu/parallel/mesh.py``).

The JAX package runs one process over N devices and lets GSPMD place the
collectives. The port runs one process per rank (started by ``torchrun``
or spawned by a test) and calls the collectives itself. A :class:`Mesh`
is a small record of that: the world size, the sizes of the named axes
(``data``, ``spatial``, ``member``, ``model``), this rank's coordinate on
each, one process group per axis and the rank's device. Ranks are laid
out row-major over the axes in that order (the last axis varies fastest),
as ``np.reshape`` lays devices out in the JAX meshes. A mesh with both a
"data" and a "spatial" axis also has their joint group (the ranks that
share the other coordinates), over which the training step averages its
gradients.

Outside ``torch.distributed`` (no process group) a mesh is a world of
one, and every collective is the identity. An axis of size 1 has no
group and no collective, so a world of one started by ``torchrun`` runs
none; an axis as large as the world uses the default group.

Collectives of CUDA tensors run where the group's backend runs them:
NCCL on a card, gloo for the CPU tests. Gloo all-reduces and broadcasts
CUDA tensors in place; :func:`all_gather` stages a CUDA tensor through
host memory under gloo (the two-processes-on-one-card arrangement of
``chip_smoke.py``: NCCL will not put two ranks on one GPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from probunet_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MEMBER_AXIS = "member"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPATIAL_AXIS, MEMBER_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class Mesh:
    """The ranks of a run as a grid of named axes, seen from one rank."""

    shape: dict[str, int]            # axis -> size, in AXES order
    coords: dict[str, int]           # axis -> this rank's coordinate
    groups: dict[str, object] = field(repr=False)   # axis -> process group or None
    device: torch.device = torch.device("cpu")
    rank: int = 0
    world_size: int = 1

    def size(self, axis: str | tuple[str, ...]) -> int:
        """The axis's size; of a tuple of axes, their product."""
        if isinstance(axis, tuple):
            return math.prod(self.size(a) for a in axis)
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str | tuple[str, ...]):
        """The axis's process group; None where the axis has size 1. A
        tuple of axes names the group of the ranks that share every other
        coordinate (``mesh_of`` makes the ("data", "spatial") one)."""
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if self.size(a) > 1)
            if len(axis) <= 1:
                return self.groups.get(axis[0]) if axis else None
        return self.groups.get(axis)

    @property
    def is_main(self) -> bool:
        """Rank 0, which writes a run's files."""
        return self.rank == 0


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _backend() -> str | None:
    return dist.get_backend() if dist.is_available() and dist.is_initialized() else None


def mesh_of(sizes: dict[str, int], device: str | torch.device | None = None) -> Mesh:
    """A mesh of the named axis sizes over every rank of the world (their
    product must be the world size). Every rank must call it, with the same
    sizes, in the same order as its other group creations: the process
    groups are made here. ``device``: the rank's device (the CUDA device
    unless the caller passes ``device="cpu"``)."""
    unknown = set(sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; axes are {AXES}")
    shape = {a: int(sizes[a]) for a in AXES if a in sizes}
    if any(n < 1 for n in shape.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    rank, n = world()
    want = math.prod(shape.values())
    if want != n:
        raise ValueError(f"mesh {shape} needs {want} ranks, the world has {n}")
    grid = np.arange(n).reshape([shape[a] for a in shape])
    coords = dict(zip(shape, (int(i) for i in np.unravel_index(rank, grid.shape))))
    groups: dict = {}
    pair = (DATA_AXIS, SPATIAL_AXIS)
    joint = [pair] if all(shape.get(a, 1) > 1 for a in pair) else []
    for axes in [(a,) for a in shape] + joint:
        size = math.prod(shape[a] for a in axes)
        key = axes[0] if len(axes) == 1 else axes
        if size == 1 or _backend() is None:
            groups[key] = None
        elif size == n:
            groups[key] = dist.group.WORLD
        else:
            # one group per line of ranks along the axes; every rank makes
            # every group, in the same order
            idx = [list(shape).index(a) for a in axes]
            lines = np.moveaxis(grid, idx, list(range(-len(idx), 0))).reshape(-1, size)
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[key] = g
    return Mesh(shape=shape, coords=coords, groups=groups,
                device=resolve_device(device), rank=rank, world_size=n)


def make_mesh(n_data: int | None = None, n_spatial: int = 1,
              device: str | torch.device | None = None) -> Mesh:
    """A ("data", "spatial") mesh over the world's ranks (the spatial axis
    varies fastest: the ranks of one data slab are neighbours);
    ``n_data=None`` takes the world size over ``n_spatial``. A mesh the
    world does not hold raises ``ValueError``."""
    _, n = world()
    if n_data is None:
        if n % n_spatial:
            raise ValueError(f"{n} ranks not divisible by n_spatial={n_spatial}")
        n_data = n // n_spatial
    return mesh_of({DATA_AXIS: n_data, SPATIAL_AXIS: n_spatial}, device)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """The rows of a global batch of ``batch_size`` this rank holds: a
    contiguous slab over the "data" axis. Raises when the batch does not
    divide by the axis."""
    n = mesh.size(DATA_AXIS)
    if batch_size % n:
        raise ValueError(f"a batch of {batch_size} does not divide over the data axis "
                         f"of size {n}")
    per = batch_size // n
    i = mesh.coord(DATA_AXIS)
    return slice(i * per, (i + 1) * per)


def row_sharding(mesh: Mesh, height: int) -> slice:
    """The rows of an image of ``height`` rows this rank holds: a contiguous
    block over the "spatial" axis, in rank order. Raises when the rows do
    not divide by the axis."""
    n = mesh.size(SPATIAL_AXIS)
    if height % n:
        raise ValueError(f"{height} rows do not divide over the spatial axis of size {n}")
    per = height // n
    i = mesh.coord(SPATIAL_AXIS)
    return slice(i * per, (i + 1) * per)


def replicated(mesh: Mesh) -> torch.device:
    """Where a replicated value lives: whole, on every rank's device."""
    return mesh.device


def shard_batch(batch, mesh: Mesh, spatial: bool | None = None):
    """This rank's block of a global batch: an array or tensor, or a dict,
    list or tuple of them, on the rank's device. Every value of one or more
    dimensions gives its slab of rows (:func:`batch_sharding`); with
    ``spatial`` (by default where the mesh's "spatial" axis is larger than
    1) an NHWC value (4-d) also gives its block of image rows
    (:func:`row_sharding`), as the JAX package's
    P("data", "spatial", None, None). 0-d values are kept whole."""
    if spatial is None:
        spatial = mesh.size(SPATIAL_AXIS) > 1
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, spatial) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)) and not isinstance(batch, torch.Tensor):
        out = [shard_batch(v, mesh, spatial) for v in batch]
        return type(batch)(*out) if hasattr(batch, "_fields") else type(batch)(out)
    if batch is None:
        return None
    t = torch.as_tensor(batch)
    if t.dim() == 0:
        return t.to(mesh.device)
    t = t[batch_sharding(mesh, t.shape[0])]
    if spatial and t.dim() == 4:
        t = t[:, row_sharding(mesh, t.shape[1])]
    return t.contiguous().to(mesh.device)


# ---------------------------------------------------------------------------
# Collectives over one axis
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str | tuple[str, ...] = DATA_AXIS,
                op: str = "sum") -> torch.Tensor:
    """Sum ``t`` over the axis's ranks (of a tuple of axes, over their
    joint group), in place; returns ``t``. ``op="max"``: the elementwise
    largest value instead of the sum."""
    g = mesh.group(axis)
    if g is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=g)
    return t


def _memory_order(t: torch.Tensor) -> list[int]:
    """t's dimensions from the outermost in memory to the innermost (a
    gradient of a channels_last convolution weight is not row-major)."""
    order = sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))
    return order if t.permute(order).is_contiguous() else list(range(t.dim()))


def mean_over(tensors: list[torch.Tensor], mesh: Mesh,
              axis: str | tuple[str, ...] = DATA_AXIS) -> list[torch.Tensor]:
    """The tensors averaged over the axis's ranks (of a tuple of axes, over
    their joint group: the training step's gradients over ("data",
    "spatial")) by one all-reduce of one flat f32 buffer, in list order:
    the sum over the ranks, then one division by their count. Each tensor is packed in its own memory order
    and comes back as a view of the buffer with its strides, so a reduction
    over it (the gradients' norm) adds in the order it would without the
    all-reduce. Without a group (an axis of size 1) the tensors come back
    as they are."""
    if mesh.group(axis) is None:
        return tensors
    orders = [_memory_order(t) for t in tensors]
    flat = torch.cat([t.detach().permute(o).reshape(-1).float()
                      for t, o in zip(tensors, orders)])
    all_reduce_(flat, mesh, axis)
    flat.div_(mesh.size(axis))
    out, i = [], 0
    for t, o in zip(tensors, orders):
        part = flat[i:i + t.numel()].view([t.shape[d] for d in o])
        out.append(part.permute(sorted(range(t.dim()), key=o.__getitem__)).to(t.dtype))
        i += t.numel()
    return out


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` from rank 0 of the world, in place; returns ``t``."""
    if _backend() is not None and mesh.world_size > 1:
        dist.broadcast(t, src=0)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str | None = None) -> list[torch.Tensor]:
    """Every rank's ``t`` along the axis (the world with None), in the
    axis's order; every rank's ``t`` must have one shape."""
    if axis is None:
        g = dist.group.WORLD if _backend() is not None and mesh.world_size > 1 else None
        size = mesh.world_size
    else:
        g, size = mesh.group(axis), mesh.size(axis)
    if g is None:
        return [t]
    staged = t.device.type == "cuda" and _backend() == "gloo"
    src = t.contiguous().cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=g)
    return [o.to(t.device) for o in out] if staged else out
