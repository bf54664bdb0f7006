"""Carry the JAX package's parameter tree into the port's ``state_dict``.

The Flax tree of ``probunet_tpu.models.prob_unet.ProbabilisticUNet``,
given as nested dicts of numpy arrays (``jax.device_get(params)``), maps
leaf by leaf onto the port's parameters, whose module names follow the
Flax names:

- conv kernels (``EDMConv``, the Gaussians' ``_Conv3x3``): HWIO -> OIHW;
- ``EDMLinear`` weights: (in, out) -> (out, in);
- ``EDMGroupNorm``'s ``gn/{scale,bias}`` -> ``weight``/``bias``;
- Fcomb's ``layer{0,1,2}_weight``: the (1, 1, cin, cout) 1x1-conv shape ->
  the (cin, cout) matrix;
- biases as they are.

Every leaf must be consumed and every port parameter filled, with equal
shapes; anything else raises.
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
    if name == "weight" and arr.ndim == 4:
        return ".".join(path), arr.transpose(3, 2, 0, 1)
    if name == "weight" and arr.ndim == 2:
        return ".".join(path), arr.T
    if name == "bias" or name.endswith("_bias"):
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
