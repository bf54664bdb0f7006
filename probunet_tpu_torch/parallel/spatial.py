"""Spatial-domain parallelism: a rank's block of image rows, halo
exchange, the sum over the "spatial" axis, and full-domain tiled
inference (port of ``probunet_tpu/parallel/spatial.py`` and of what GSPMD
inserts for ``P("data", "spatial", None, None)``).

1. :class:`Rows`: a mesh whose "spatial" axis splits each image's rows
   into contiguous blocks, one block per rank in rank order. The record
   (the mesh, the axis, this rank's first row and the global height at
   the input's resolution) is passed explicitly through the model, the
   way a data slab's (first row, global batch) is; at any resolution a
   block of h rows starts at row ``index * h`` of ``parts * h``. Nothing
   is held in a module-level context.
2. :func:`halo_exchange` / :func:`halo_conv2d`: a rank pads its block
   with ``halo`` rows of each neighbour (zero rows at the global edges),
   and a VALID convolution of the padded block over the rows equals the
   rows of the unsharded SAME convolution. The JAX function sends the rows
   with ``lax.ppermute``; here one all-gather of every rank's edge rows
   carries them, because gloo, which the CPU tests and two processes
   sharing one card use, sends and receives only host tensors
   (``mesh.all_gather`` stages a card's tensors through host memory under
   gloo). A block of fewer rows than the halo (MS-SSIM's coarsest scale
   on four ranks) takes its rows from ranks beyond the neighbour: the
   all-gather then carries every rank's whole block. The exchange is
   differentiable: a halo row's gradient goes back to the rank that owns
   the row and is added there.
3. :func:`sum_over`: the all-reduce-sum over the axis (the JAX package's
   ``psum``), differentiable: its backward all-reduces the incoming
   gradient. Global statistics of a block (GroupNorm's sums, the
   encoders' average pool, the CRPS terms) are its partial sums summed
   this way.

   **The gradient convention** of the spatially sharded step: every rank
   differentiates the replicated loss (its value is the same on every
   rank of the axis, since each term that crosses rows is all-reduced);
   the collectives' backwards route each activation's gradient to the
   rank that holds it; and the parameter gradients are then averaged over
   ("data", "spatial") by one all-reduce (``mesh.mean_over``). That is
   the same as each rank differentiating its share of the loss (the
   replicated loss divided by n_spatial), the gradients summed over
   "spatial" and averaged over "data": the division by a power of two is
   exact, so both give the same bits.
4. :func:`extract_tiles` / :func:`stitch_tiles` / :func:`tiled_ensemble`:
   a domain of any size (the full 280x280 ClimEx grid) cut into the
   model's native window with overlapping, optionally aligned tiles; the
   per-tile ensembles blended back with a cosine ramp, accumulated tile by
   tile in the JAX package's order, so the stitched field equals its. With
   a mesh, each chunk of tiles is split over the "data" axis and gathered
   back before the stitch.

Under n_spatial > 1 only ``UNetBlock``'s self-attention, which no
Probabilistic U-Net path enables, raises :func:`deferred`'s
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from probunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    all_gather,
    all_reduce_,
)

ROADMAP_ITEM = "ROADMAP.md §1 item 11"


def deferred(what: str) -> NotImplementedError:
    """The error a deferred option raises under n_spatial > 1."""
    return NotImplementedError(f"{what} under a mesh with n_spatial > 1 is not ported "
                               f"({ROADMAP_ITEM})")


# ---------------------------------------------------------------------------
# A rank's block of rows
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rows:
    """This rank's block of image rows over ``axis``: rows [h0, h0 + h) of
    ``height`` at the input's resolution, every rank's block of one size."""

    mesh: Mesh
    h0: int
    height: int
    axis: str = SPATIAL_AXIS

    @property
    def parts(self) -> int:
        return self.mesh.size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.coord(self.axis)

    def first(self, h: int) -> int:
        """The first global row of this rank's block of ``h`` rows (at the
        resolution where a block has h rows)."""
        return self.index * h

    def whole(self, h: int) -> int:
        """The global height where a block has ``h`` rows."""
        return self.parts * h

    def halo(self, x: torch.Tensor, halo: int, row_axis: int = 1) -> torch.Tensor:
        """:func:`halo_exchange` of ``x`` over the axis."""
        return halo_exchange(x, halo, self.mesh, self.axis, row_axis)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """:func:`sum_over` the axis (differentiable)."""
        return sum_over(t, self.mesh, self.axis)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis in place, outside autograd (a kernel's
        partial statistics)."""
        return all_reduce_(t, self.mesh, self.axis)


def rows_of(mesh: Mesh, h: int, axis: str = SPATIAL_AXIS) -> Rows | None:
    """The :class:`Rows` of this rank's block of ``h`` rows over ``axis``;
    None where the axis has size 1 (the unsharded model)."""
    n = mesh.size(axis)
    if n == 1:
        return None
    return Rows(mesh, h0=mesh.coord(axis) * h, height=n * h, axis=axis)


def check_block(h: int, lowres_scale: int, levels: int, msssim_scales: int = 0) -> None:
    """A block of ``h`` rows must divide by the pooling factor
    ``lowres_scale`` (the LR grid is pooled on each rank) and by 2 **
    (levels - 1) (the U-Net's and the encoders' 2x2 pools stay local);
    for the MS-SSIM ELBO (``msssim_scales`` > 0) also by 2 **
    (msssim_scales - 1) (its 2x2 pools between scales stay local). Raises
    ``ValueError`` where it does not."""
    factors = [(lowres_scale, "the pooling factor"),
               (2 ** (levels - 1), f"2^{levels - 1} of the {levels} levels' pools")]
    if msssim_scales:
        factors.append((2 ** (msssim_scales - 1),
                        f"2^{msssim_scales - 1} of MS-SSIM's {msssim_scales} scales"))
    for f, what in factors:
        if h % f:
            raise ValueError(f"a block of {h} rows does not divide by {f} ({what}): choose "
                             "n_spatial so each rank's rows do")


# ---------------------------------------------------------------------------
# Halo exchange and the sum over the axis
# ---------------------------------------------------------------------------

def _neighbours(edges: torch.Tensor, mesh: Mesh, axis_name: str):
    """(the block above's last rows, the block below's first rows) from
    every rank's (first, last) ``edges``; None at a global edge."""
    blocks = all_gather(edges, mesh, axis_name)   # (first rows, last rows) a rank
    pos, n = mesh.coord(axis_name), mesh.size(axis_name)
    return (blocks[pos - 1][1] if pos > 0 else None,
            blocks[pos + 1][0] if pos < n - 1 else None)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, mesh, axis_name, row_axis):
        ctx.consts = (halo, mesh, axis_name, row_axis)
        if x.shape[row_axis] < halo:
            return _whole_padded(x, halo, mesh, axis_name, row_axis)
        edges = torch.stack([x.narrow(row_axis, 0, halo),
                             x.narrow(row_axis, x.shape[row_axis] - halo, halo)])
        top, bottom = _neighbours(edges, mesh, axis_name)
        zeros = torch.zeros_like(edges[0])
        return torch.cat([zeros if top is None else top, x,
                          zeros if bottom is None else bottom], dim=row_axis)

    @staticmethod
    def backward(ctx, g):
        halo, mesh, axis_name, row_axis = ctx.consts
        h = g.shape[row_axis] - 2 * halo
        if h < halo:
            return _whole_padded_grad(g, halo, mesh, axis_name, row_axis), None, None, None, None
        # the padded rows' gradients go back to the ranks that own the rows
        edges = torch.stack([g.narrow(row_axis, 0, halo),
                             g.narrow(row_axis, h + halo, halo)])
        above, below = _neighbours(edges, mesh, axis_name)
        gx = g.narrow(row_axis, halo, h).contiguous()
        if above is not None:   # the block above's bottom halo is our first rows
            gx.narrow(row_axis, 0, halo).add_(above)
        if below is not None:   # the block below's top halo is our last rows
            gx.narrow(row_axis, h - halo, halo).add_(below)
        return gx, None, None, None, None


def _whole_padded(x, halo, mesh, axis_name, row_axis):
    """The halo-padded block of a block smaller than the halo: every
    rank's block gathered into the whole image, zero rows added at its
    edges, this rank's window cut out."""
    whole = torch.cat(all_gather(x, mesh, axis_name), dim=row_axis)
    padded = F.pad(whole, [0, 0] * (x.dim() - 1 - row_axis % x.dim()) + [halo, halo])
    h = x.shape[row_axis]
    return padded.narrow(row_axis, mesh.coord(axis_name) * h, h + 2 * halo)


def _whole_padded_grad(g, halo, mesh, axis_name, row_axis):
    """The backward of :func:`_whole_padded`: every rank's padded-window
    gradient added into the padded image in rank order, this rank's rows
    cut out."""
    h = g.shape[row_axis] - 2 * halo
    parts = all_gather(g, mesh, axis_name)
    shape = list(g.shape)
    shape[row_axis] = len(parts) * h + 2 * halo
    full = g.new_zeros(shape)
    for r, part in enumerate(parts):
        full.narrow(row_axis, r * h, h + 2 * halo).add_(part)
    return full.narrow(row_axis, halo + mesh.coord(axis_name) * h, h).contiguous()


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh, axis_name: str = SPATIAL_AXIS,
                  row_axis: int = 1) -> torch.Tensor:
    """This rank's block ``x`` (rows ``row_axis`` of an image split over
    ``axis_name`` in rank order) with ``halo`` rows of each neighbour added
    above and below; the first and last blocks get zero rows at the
    image's edges (the SAME convolution's padding). Returns a block with
    ``2 * halo`` more rows; differentiable (the halo rows' gradients are
    added to their owners' rows). Every rank of the axis must call it. A
    block smaller than the halo takes rows from ranks beyond its
    neighbours."""
    if halo == 0:
        return x
    return _HaloExchange.apply(x, halo, mesh, axis_name, row_axis)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis_name):
        ctx.consts = (mesh, axis_name)
        return all_reduce_(t.detach().clone(), mesh, axis_name)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), *ctx.consts), None, None


def sum_over(t: torch.Tensor, mesh: Mesh, axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """``t`` summed over the axis's ranks (every rank gets the sum);
    differentiable: the backward sums the incoming gradients over the
    axis. Without a group (an axis of size 1) ``t`` itself."""
    if mesh.group(axis_name) is None:
        return t
    return _SumOver.apply(t, mesh, axis_name)


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
