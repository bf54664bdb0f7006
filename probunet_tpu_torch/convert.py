"""Carry the JAX package's parameter tree into the port's ``state_dict``.

The Flax tree of a JAX model (``ProbabilisticUNet``, ``UNetAll`` with
its ``PostUNet*`` variants, ``LinearCNN``, ``EDMPrecond`` with its
``model/map_*`` mapping network), given as nested dicts of
numpy arrays (``jax.device_get(params)``), maps leaf by leaf onto the
port's parameters, whose module names follow the Flax names
(``unet/core_unet/...``, ``post{l}_up``, ``post{l}_skipconv{i}``,
``post{l}_block{i}``, ``out_norm``, ``out_conv``, ``first_conv``):

- conv kernels (``EDMConv``, the Gaussians' ``_Conv3x3``): HWIO -> OIHW;
  a Flax ``nn.Conv``'s ``kernel`` leaf likewise, into the port's
  ``nn.Conv2d`` ``weight``;
- ``EDMLinear`` weights: (in, out) -> (out, in);
- ``EDMGroupNorm``'s ``gn/{scale,bias}`` -> ``weight``/``bias``;
- Fcomb's ``layer{0,1,2}_weight``: the (1, 1, cin, cout) 1x1-conv shape ->
  the (cin, cout) matrix;
- biases and ``FourierEmbedding``'s ``freqs`` as they are.

Every leaf must be consumed and every port parameter filled, with equal
shapes; anything else raises. ``convert_quant`` and ``flax_quant`` carry
the int8 serving scales tree (the JAX "quant" collection) both ways;
``convert_channel_sharded`` the tensor-parallel conv pair's two kernels
(HWIO -> OIHW), which no module holds.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _convert_leaf(path: tuple[str, ...], arr: np.ndarray) -> tuple[str, np.ndarray]:
    name = path[-1]
    if len(path) >= 2 and path[-2] == "gn" and name in ("scale", "bias"):
        return ".".join(path[:-2] + ("weight" if name == "scale" else "bias",)), arr
    if name.startswith("layer") and name.endswith("_weight"):  # Fcomb
        if arr.ndim != 4 or arr.shape[:2] != (1, 1):
            raise ValueError(f"{'/'.join(path)}: expected (1, 1, cin, cout), got {arr.shape}")
        return ".".join(path), arr[0, 0]
    if name in ("weight", "kernel") and arr.ndim == 4:
        return ".".join(path[:-1] + ("weight",)), arr.transpose(3, 2, 0, 1)
    if name == "weight" and arr.ndim == 2:
        return ".".join(path), arr.T
    if name == "bias" or name.endswith("_bias") or name == "freqs":
        return ".".join(path), arr
    raise ValueError(f"no conversion rule for {'/'.join(path)} {arr.shape}")


def convert_params(params: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The port ``state_dict`` for ``model`` from the Flax tree ``params``."""
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    unknown, mismatched = [], {}
    for path, arr in _flatten(params):
        key, val = _convert_leaf(path, arr)
        if key not in expected:
            unknown.append(key)
        elif tuple(val.shape) != tuple(expected[key].shape):
            mismatched[key] = f"{val.shape} vs {tuple(expected[key].shape)}"
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(val, dtype=np.float32))
    missing = sorted(set(expected) - set(out) - set(mismatched))
    if unknown or mismatched or missing:
        raise ValueError(
            "parameter trees do not match:"
            + (f"\n  leaves with no port parameter: {unknown}" if unknown else "")
            + (f"\n  shape mismatches: {mismatched}" if mismatched else "")
            + (f"\n  port parameters not filled: {missing}" if missing else ""))
    return out


def flax_params(model: nn.Module) -> dict:
    """The inverse of :func:`convert_params`: the port's parameters as the
    JAX package's nested tree of numpy arrays."""
    from probunet_tpu_torch.models.fcomb import Fcomb
    from probunet_tpu_torch.models.layers import EDMGroupNorm

    tree: dict = {}
    for mod_name, mod in model.named_modules():
        for pname, prm in mod.named_parameters(recurse=False):
            arr = prm.detach().cpu().numpy()
            path = tuple(mod_name.split(".")) if mod_name else ()
            if isinstance(mod, EDMGroupNorm):
                path += ("gn", "scale" if pname == "weight" else "bias")
            elif isinstance(mod, Fcomb) and pname.endswith("_weight"):
                path, arr = path + (pname,), arr[None, None]
            elif isinstance(mod, nn.Conv2d) and pname == "weight":  # Flax nn.Conv
                path, arr = path + ("kernel",), arr.transpose(2, 3, 1, 0)
            elif pname == "weight" and arr.ndim == 4:
                path, arr = path + (pname,), arr.transpose(2, 3, 1, 0)
            elif pname == "weight" and arr.ndim == 2:
                path, arr = path + (pname,), arr.T
            else:
                path += (pname,)
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def load_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load the Flax tree ``params`` into ``model`` in place (strict)."""
    model.load_state_dict(convert_params(params, model), strict=True)
    return model


def convert_quant(tree: Mapping, model: nn.Module) -> dict:
    """The JAX package's "quant" collection (nested dicts of f32 scalars,
    ``{"unet": {"enc_128x128_conv": {"in_scale": s}}}``) as the port's
    scales tree for ``model`` (0-d f32 tensors, ``ops.quantize``): every
    path must name a hooked convolution of ``model`` and every leaf be
    ``in_scale`` or ``in_scale2``, else it raises."""
    from probunet_tpu_torch.ops.quantize import SCALE_NAMES, hooked_convs

    convs = hooked_convs(model)
    out: dict = {}
    bad = []
    for path, arr in _flatten(tree):
        if "/".join(path[:-1]) not in convs or path[-1] not in SCALE_NAMES.values() \
                or arr.size != 1:
            bad.append("/".join(path))
            continue
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = torch.tensor(float(np.asarray(arr, np.float32).reshape(())),
                                      dtype=torch.float32)
    if bad:
        raise ValueError(f"quant scales naming no hooked convolution of the model: {bad}")
    return out


def flax_quant(scales: Mapping) -> dict:
    """The inverse of :func:`convert_quant`: a port scales tree as the JAX
    package's nested dict of f32 numpy scalars."""
    return {k: flax_quant(v) if isinstance(v, Mapping)
            else np.float32(torch.as_tensor(v).item()) for k, v in scales.items()}


def convert_channel_sharded(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX ``parallel.tensor_parallel`` pair's two HWIO kernels
    {"w1", "w2"} as the port's OIHW tensors (f32), whole: each rank takes
    its channel slices with ``parallel.tensor_parallel.shard_params``."""
    if set(params) != {"w1", "w2"}:
        raise ValueError(f"expected the leaves w1 and w2, got {sorted(params)}")
    out = {}
    for name in ("w1", "w2"):
        arr = np.asarray(params[name])
        if arr.ndim != 4:
            raise ValueError(f"{name}: expected an HWIO kernel, got {arr.shape}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
    return out
