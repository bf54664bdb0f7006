"""Tensor (model) parallelism: a channel-sharded convolution pair (port of
``probunet_tpu/parallel/tensor_parallel.py``).

The Megatron two-matmul pattern on a pair of convolutions over a ("data",
"model") mesh:

  conv1: weights (Cmid, Cin, kh, kw), each rank holding its Cmid / n slice
         of the output channels -> its slice of relu(conv1(x)), with no
         communication;
  conv2: weights (Cout, Cmid, kh, kw), each rank holding the same Cmid / n
         slice of the input channels -> a partial sum of the output, which
         one all-reduce over "model" completes.

The JAX module states the placements and GSPMD derives the all-reduce;
here the rank slices its weights (:func:`shard_params`) and calls the
all-reduce itself. The batch may be split over "data" besides. The
products are ``F.conv2d`` (XLA convolutions in the JAX package, no TPU
kernel of their own).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from probunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    all_reduce_,
    batch_sharding,
    mesh_of,
    world,
)


def make_dp_tp_mesh(n_model: int, n_data: int | None = None,
                    device: str | torch.device | None = None) -> Mesh:
    """A ("data", "model") mesh; the ranks left over go to the data axis."""
    _, n = world()
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    return mesh_of({DATA_AXIS: n_data, MODEL_AXIS: n_model}, device)


def init_channel_sharded_params(generator: torch.Generator, c_in: int, c_mid: int, c_out: int,
                                kernel: int = 3) -> dict[str, torch.Tensor]:
    """The pair's two OIHW kernels, standard normal over sqrt(fan-in), drawn
    from ``generator`` on its device (whole: :func:`shard_params` slices
    them). A pair made by the JAX function crosses over through
    ``convert.convert_channel_sharded``."""
    dev = generator.device
    w1 = torch.randn((c_mid, c_in, kernel, kernel), generator=generator, device=dev)
    w2 = torch.randn((c_out, c_mid, kernel, kernel), generator=generator, device=dev)
    return {"w1": w1 / math.sqrt(kernel * kernel * c_in),
            "w2": w2 / math.sqrt(kernel * kernel * c_mid)}


def shard_params(params: dict[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slices of the whole pair on its device: w1's output
    channels and w2's input channels of its Cmid / n part."""
    n, i = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    c_mid = params["w1"].shape[0]
    if c_mid % n:
        raise ValueError(f"Cmid={c_mid} does not divide over the model axis of size {n}")
    part = slice(i * c_mid // n, (i + 1) * c_mid // n)
    return {"w1": params["w1"][part].contiguous().to(mesh.device),
            "w2": params["w2"][:, part].contiguous().to(mesh.device)}


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME convolution of an NHWC tensor with an OIHW kernel, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def channel_sharded_block(params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """relu(conv1) -> conv2 on one process with the whole pair: the
    unsharded counterpart (NHWC in and out)."""
    return _conv(F.relu(_conv(x, params["w1"])), params["w2"])


def make_channel_sharded_apply(mesh: Mesh):
    """apply(local_params, x) -> this rank's rows of the pair's output.

    ``local_params`` are :func:`shard_params`'s slices; ``x`` is the global
    NHWC batch, of which the rank keeps its "data" slab. conv1 on the
    rank's channels, relu, conv2's partial sum, one all-reduce over
    "model"."""

    def apply(local_params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        x = x[batch_sharding(mesh, x.shape[0])]
        h = F.relu(_conv(x.to(mesh.device), local_params["w1"]))
        partial = _conv(h, local_params["w2"]).contiguous()
        return all_reduce_(partial, mesh, MODEL_AXIS)

    return apply
