"""Dropout masks of the U-Net's GroupNorm chains, as pure functions of
(position, two seed words): a murmur3 finalizer of the position, the seed
words and a salt, kept at 1 - p. A frozen copy of the program's plain
versions (its hash, its three routes and the rule that picks a route from
the chain's shape), in int64 arithmetic masked to 32 bits.

``keep(shape, seed2, p, b0, b_total)`` is the mask of items ``b0`` ..
``b0 + shape[0]`` of a chain whose whole batch is ``b_total`` items, on
the NHWC shape ``shape``, so the reference can take the batch in blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_LANE = 128
_MAX_BLOCK_ROWS = 2048


def _mul32(z: torch.Tensor, m: int) -> torch.Tensor:
    lo = z * (m & 0xFFFF)
    hi = (z * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def hash_uniform(pos: torch.Tensor, seed2: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) (f32) of int64 ``pos`` and ``salt``, which broadcast."""
    sa, sb = (seed2.to(torch.int64) & _MASK32).unbind()
    z = (pos + _mul32(sa, 2654435761) + sb + salt * 40503) & _MASK32
    for mult in (0x85EBCA6B, 0xC2B2AE35):
        z = _mul32(z ^ (z >> 16), mult)
    z = z ^ (z >> 16)
    return (z >> 8).to(torch.float32) * np.float32(2.0 ** -24)


def _block_rows(rows: int) -> int | None:
    best, b = None, 8
    while b <= min(rows, _MAX_BLOCK_ROWS):
        if rows % b == 0:
            best = b
        b += 8
    return best


def chain_route(h: int, w: int, c: int, groups: int) -> bool:
    """Whether the chain takes the fused route (its mask hashes the NHWC
    index inside an item, salted with the item's index in the batch)."""
    k = _LANE // math.gcd(c, _LANE)
    return c % groups == 0 and (h * w) % k == 0 and (h * w // k) % 8 == 0


def _whole_tensor_route(n: int) -> bool:
    return n % (8 * _LANE) == 0 and _block_rows(n // _LANE) is not None


def keep(shape, seed2: torch.Tensor, p: float, b0: int, b_total: int,
         groups: int) -> torch.Tensor:
    """Bool keep mask of NHWC ``shape`` (items ``b0`` .. of a batch of
    ``b_total``)."""
    b, h, w, c = shape
    dev = seed2.device
    item = h * w * c
    thr = np.float32(p)
    if chain_route(h, w, c, groups):
        pos = torch.arange(item, dtype=torch.int64, device=dev)[None, :]
        salt = torch.arange(b0, b0 + b, dtype=torch.int64, device=dev)[:, None]
        return (hash_uniform(pos, seed2, salt) >= thr).reshape(shape)
    e = (torch.arange(b * item, dtype=torch.int64, device=dev) + b0 * item)
    total = b_total * item
    if _whole_tensor_route(total):
        rb = _block_rows(total // _LANE)
        r = e // _LANE
        u = hash_uniform((r % rb) * _LANE + e % _LANE, seed2, r // rb)
    else:
        u = hash_uniform(e, seed2, torch.zeros((), dtype=torch.int64, device=dev))
    return (u >= thr).reshape(shape)
