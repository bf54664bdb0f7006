"""Spatial-domain parallelism: halo exchange and full-domain tiled
inference (port of ``probunet_tpu/parallel/spatial.py``).

1. :func:`halo_exchange` / :func:`halo_conv2d`: a rank holding a block of
   rows of an image pads it with ``halo`` rows from its neighbours along a
   mesh axis (zero rows at the global edges), and a VALID convolution of
   the padded block equals the rows of the unsharded SAME convolution.
   The JAX function sends the rows with ``lax.ppermute``; here one
   all-gather of every rank's edge rows carries them, because gloo, which
   the CPU tests and two processes sharing one card use, sends and
   receives only host tensors. ``mesh.all_gather`` stages a card's tensors
   through host memory under gloo and gathers them on the card under NCCL.
2. :func:`extract_tiles` / :func:`stitch_tiles` / :func:`tiled_ensemble`:
   a domain of any size (the full 280x280 ClimEx grid) cut into the
   model's native window with overlapping, optionally aligned tiles; the
   per-tile ensembles blended back with a cosine ramp, accumulated tile by
   tile in the JAX package's order, so the stitched field equals its. With
   a mesh, each chunk of tiles is split over the "data" axis and gathered
   back before the stitch.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from probunet_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh, all_gather


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------

def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str = SPATIAL_AXIS,
                  row_axis: int = 1) -> torch.Tensor:
    """This rank's block ``x`` (rows ``row_axis`` of an image split over
    ``axis_name`` in rank order) with ``halo`` rows of each neighbour added
    above and below; the first and last blocks get zero rows at the
    image's edges (the SAME convolution's padding). Returns a block with
    ``2 * halo`` more rows. Every rank of the axis must call it."""
    if halo == 0:
        return x
    edges = torch.stack([x.narrow(row_axis, 0, halo),
                         x.narrow(row_axis, x.shape[row_axis] - halo, halo)])
    blocks = all_gather(edges, mesh, axis_name)   # (top rows, bottom rows) a rank
    pos, n = mesh.coord(axis_name), mesh.size(axis_name)
    zeros = torch.zeros_like(edges[0])
    top = blocks[pos - 1][1] if pos > 0 else zeros
    bottom = blocks[pos + 1][0] if pos < n - 1 else zeros
    return torch.cat([top, x, bottom], dim=row_axis)


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """SAME convolution of an NHWC image whose rows are split over
    ``axis_name``: ``x`` (B, H / n, W, C) is this rank's block, ``weight``
    (O, C, kh, kw) the kernel (OIHW, replicated); returns the rank's (B,
    H / n, W, O) block of the unsharded result. The halo exchange of
    (kh - 1) // 2 rows, then a convolution VALID over the rows and SAME
    over the columns (``F.conv2d``: the JAX function's product is an XLA
    convolution, no kernel of its own)."""
    kh, kw = weight.shape[-2:]
    padded = halo_exchange(x, (kh - 1) // 2, mesh, axis_name, row_axis=1)
    y = F.conv2d(padded.permute(0, 3, 1, 2), weight.to(x.dtype), padding=(0, (kw - 1) // 2))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Overlap-tile decomposition for full-domain inference
# ---------------------------------------------------------------------------


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


def tiled_ensemble(sample_fn: Callable, hr_full, tile: int, overlap: int = 16,
                   batch_tiles: int | None = None, align: int = 1,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Full-domain ensemble inference by overlap tiling.

    ``sample_fn(hr_tile_batch, start, rows=None) -> (B, M, tile, tile, C)``
    samples the ensemble of a batch of tiles, ``start`` being the index of
    its chunk's first tile in the day-major order of :func:`extract_tiles`
    (the caller slices per-tile inputs and draws the chunk's noise from
    it); ``hr_full`` is (T, H, W, C), its tiles aligned to ``align``. All
    tiles form one chunk, or chunks of ``batch_tiles``. Returns (T, M, H,
    W, C).

    With ``mesh``, the chunk size is rounded up to a multiple of the "data"
    axis's size; each chunk is wrap-padded to a multiple of it (its first
    tiles repeated, as the JAX CLI pads) and each rank samples its equal
    share, ``sample_fn`` receiving ``rows``, the chunk-relative indices of
    the tiles it got; the shares are all-gathered, the padding dropped, and
    every rank stitches the same field."""
    t, h, w, c = torch.as_tensor(hr_full).shape
    tiles, positions = extract_tiles(hr_full, tile, overlap, align)
    n = tiles.shape[0]
    step = batch_tiles or n
    if mesh is None:
        out = torch.cat([sample_fn(tiles[i:i + step], i) for i in range(0, n, step)])
        return stitch_tiles(out, positions, (h, w))
    parts, pos = mesh.size(DATA_AXIS), mesh.coord(DATA_AXIS)
    step = -(-step // parts) * parts
    chunks = []
    for i in range(0, n, step):
        n_real = min(step, n - i)
        per = -(-n_real // parts)
        rows = np.arange(pos * per, (pos + 1) * per) % n_real
        mine = sample_fn(tiles[i + torch.from_numpy(rows)], i, rows)
        chunks.append(torch.cat(all_gather(mine.contiguous(), mesh, DATA_AXIS))[:n_real])
    return stitch_tiles(torch.cat(chunks), positions, (h, w))
