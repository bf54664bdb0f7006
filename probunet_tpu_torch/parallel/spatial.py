"""Overlap-tile decomposition for full-domain inference (port of
``probunet_tpu/parallel/spatial.py:111-228``).

A domain of any size (the full 280x280 ClimEx grid) is cut into the
model's native window with overlapping, optionally aligned tiles; the
per-tile ensembles are blended back with a cosine ramp, accumulated tile by
tile in the JAX package's order, so the stitched field equals its. The
halo exchange of the JAX module and the tile batch sharded over a mesh wait
for the parallel paths (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch


def _tile_starts(full: int, tile: int, overlap: int, align: int = 1) -> list[int]:
    """Start offsets covering [0, full) with >= ``overlap`` shared pixels;
    ``align`` snaps every origin down to a multiple (the pooling factor, so
    per-tile pooling equals slicing the global pooled grid)."""
    if tile >= full:
        return [0]
    stride = max(align, (tile - overlap) // align * align)
    last = (full - tile) // align * align
    if last + tile < full:
        raise ValueError(
            f"domain {full} not coverable by aligned tiles (tile={tile}, "
            f"align={align}); pad the domain to a multiple of {align}")
    n = math.ceil(last / stride) + 1 if last else 1
    out: list[int] = []
    for s in (min(i * stride, last) for i in range(n)):
        if not out or s != out[-1]:   # tail tiles may clamp to the same start
            out.append(s)
    return out


def tile_positions(h: int, w: int, tile: int, overlap: int = 16,
                   align: int = 1) -> list[tuple[int, int]]:
    """The (y, x) origins of the tiles of an h x w field, row-major."""
    return [(y, x) for y in _tile_starts(h, tile, overlap, align)
            for x in _tile_starts(w, tile, overlap, align)]


def extract_tiles(field, tile: int, overlap: int = 16, align: int = 1):
    """(T, H, W, C) tensor or array -> ((T * ntiles, tile, tile, C) tensor,
    positions): the tiles day-major, ``positions`` the (y, x) origins."""
    field = torch.as_tensor(field)
    t, h, w, c = field.shape
    positions = tile_positions(h, w, tile, overlap, align)
    tiles = torch.stack([field[:, y:y + tile, x:x + tile, :] for (y, x) in positions], dim=1)
    return tiles.reshape(t * len(positions), tile, tile, c), positions


def _ramp_weight(tile: int) -> np.ndarray:
    """(tile, tile) cosine-ramp blending weight, peaked at the tile centre."""
    r = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(tile) + 0.5) / tile)
    return (np.outer(r, r) + 1e-6).astype(np.float32)


def stitch_tiles(tiles: torch.Tensor, positions: Sequence[tuple[int, int]],
                 full_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`extract_tiles` with the ramp blending.

    tiles: (T * ntiles, *extra, tile, tile, C), extra axes (the ensemble
    members) after the flattened tile axis. Returns (T, *extra, H, W, C)."""
    ntiles = len(positions)
    tile, c = tiles.shape[-3], tiles.shape[-1]
    h, w = full_hw
    lead = tuple(tiles.shape[1:-3])
    t = tiles.shape[0] // ntiles
    tiles = tiles.reshape((t, ntiles) + lead + (tile, tile, c))
    wgt = torch.from_numpy(_ramp_weight(tile))[:, :, None].to(tiles.device, tiles.dtype)
    acc = torch.zeros((t,) + lead + (h, w, c), dtype=tiles.dtype, device=tiles.device)
    den = torch.zeros((h, w, 1), dtype=tiles.dtype, device=tiles.device)
    for i, (y, x) in enumerate(positions):
        acc[..., y:y + tile, x:x + tile, :] += tiles[:, i] * wgt
        den[y:y + tile, x:x + tile, :] += wgt
    return acc / den


def tiled_ensemble(sample_fn: Callable[[torch.Tensor, int], torch.Tensor], hr_full, tile: int,
                   overlap: int = 16, batch_tiles: int | None = None,
                   align: int = 1) -> torch.Tensor:
    """Full-domain ensemble inference by overlap tiling, on one device.

    ``sample_fn(hr_tile_batch, start) -> (B, M, tile, tile, C)`` samples the
    ensemble of a batch of tiles, ``start`` being the index of its first
    tile in the day-major order of :func:`extract_tiles` (the caller slices
    per-tile inputs and draws its noise from it); ``hr_full`` is (T, H, W,
    C), its tiles aligned to ``align``. All tiles form one batch, or chunks
    of ``batch_tiles``. Returns (T, M, H, W, C)."""
    t, h, w, c = torch.as_tensor(hr_full).shape
    tiles, positions = extract_tiles(hr_full, tile, overlap, align)
    step = batch_tiles or tiles.shape[0]
    out = torch.cat([sample_fn(tiles[i:i + step], i) for i in range(0, tiles.shape[0], step)])
    return stitch_tiles(out, positions, (h, w))
