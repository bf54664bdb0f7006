"""The U-Net's GroupNorm chain: CUDA kernels (``csrc/fused_gn.cu``) and
plain version.

Port of ``probunet_tpu/ops/pallas/fused_gn.py``, forward (kernel C) and
analytic backward (kernel C′):

    y = dropout(silu((gn(x) * gamma + beta) * (scale + 1) + shift))

for x (B, H, W, C) NHWC in bf16 or f32, gamma/beta (C,) and scale/shift
(B, C) in f32, with G groups. The plain version copies the TPU kernel's
formula, not the flax composition: s1 = sum x and s2 = sum x*x (the
product rounded to x's type) in f32 per (batch, group); mean = s1 / n,
rstd = rsqrt(s2 / n - mean^2 + eps) with no clamp at 0, n = H*W*C/G; the
collapsed affine p = rstd*gamma, a = p*(scale+1), b = (beta - mean*p) *
(scale+1) + shift; z = x*a + b in f32, SiLU, dropout and one cast to x's
type. Its backward is the kernel's formula (``fused_gn.py:153-208``), not
autograd through the plain forward.

The dropout mask is the JAX kernel's bit for bit: ``_dropout_uniform``
hashes the lane-packed block index r*(k*C) + col, which is the NHWC index
(h*W + w)*C + c inside a batch element, salted with the batch index
(:func:`gn_keep`, through ``dropout.hash_uniform``). The backward
regenerates the mask; the autograd residuals are x, mean, rstd and the
seed words, as the JAX ``_vjp_fwd`` saves them. A data-parallel rank's
slab of the global batch, its first row at b0, gets the global rows'
masks from the seed words :func:`slab_seed` makes: the hash adds salt *
40503 to the second seed word, so b0 * 40503 added there is b0 added to
every salt (offset 0: the seed words themselves). Likewise a spatial
rank's block of rows, its first row at h0 of a chain of width W and C
channels, sits at position pos + h0*W*C of each element: h0*W*C added to
the second seed word is that shift of every position.

Under a spatial mesh the chain's statistics cover rows held on other
ranks, so C and C′ run split (:func:`gn_split_fwd`, :func:`gn_split_bwd`,
the ``rows`` argument of :func:`gn_film_silu_dropout`): C's statistics
pass writes the block's per-tile partial s1, s2 ((2, B, T, C) f32), the
caller's ``reduce`` sums them over the ranks in place, and the finalize
and apply passes run on the sums with the global element count n. C′
writes the block's partial Sdz, Sdzx, from which its dgamma, dbeta,
dscale and dshift come (per-rank terms that the parameter all-reduce adds
up); after ``reduce``, c1, c2, c3 come from the sums and the dx pass runs.
The split plain versions, the CPU route, gather the image instead: a
block's x (C), or its dz and dz*x (C′), placed at its rows (from ``h0``)
among zero rows of the image's ``height`` and summed over the ranks by
``reduce``, each element one block's value plus zeros, so every rank
holds the image's values exactly and takes its statistics (C) or sums
(C′) as the whole chain's plain version does, bit for bit. A sharded
step on the CPU thus takes the one-process step's GroupNorm forward and
dx exactly, and no ReLU gate downstream flips on the rounding of a
partial sum; the per-rank parameter terms of C′ stay the block's. The
price is the CPU's alone: a rank holds the (B, height, W, C) f32 image
of a chain (C′: two of them) and each collective moves it, where the
kernels' route moves (2, B, T, C) partials. So the card's route differs
from its plain version in the order of the image sums, by f32 rounding,
and the kernels ignore ``h0``: their partials do not depend on where the
block lies.

Kernels C and C′ each follow a plan made here per shape, before the
launch (:func:`fwd_plan`, :func:`bwd_plan`): one thread-block cluster
per batch element and channel part, which keeps the part's x (and, in
C′, dz) in shared memory so x (and g) are read once, where the card ran
that faster; elsewhere C's three passes and C′'s two.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from probunet_tpu_torch.ops.kernels import _build
from probunet_tpu_torch.ops.kernels.dropout import _MASK32, hash_uniform

SOURCE = "probunet_tpu_torch/csrc/fused_gn.cu"
REPLACES = "probunet_tpu/ops/pallas/fused_gn.py:247"
REPLACES_BWD = "probunet_tpu/ops/pallas/fused_gn.py:282"

_LANE = 128

# The cluster routes of C and C′ (csrc/fused_gn.cu:gn_fwd_cluster_kernel,
# gn_bwd_cluster_kernel) on the H100: a block's threads, the most blocks of
# a cluster (the portable 8), the most shared memory a block takes (227 KB)
# less room for its static part, the budget that leaves two blocks on each
# SM's 228 KB, an SM's shared memory and threads with the 1 KB the runtime
# reserves per block, and the blocks an SM's 64K registers hold under each
# kernel's launch bounds (C: 64 registers a thread, C′: up to 128).
CLUSTER_THREADS = 256
MAX_CLUSTER = 8
SMEM_PER_BLOCK = 227 * 1024 - 1024
SMEM_TWO_PER_SM = 112 * 1024
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048
FWD_REGISTER_BLOCKS = 4
BWD_REGISTER_BLOCKS = 2
TWO_PASS = {"route": "two_pass"}
THREE_PASS = {"route": "three_pass"}


def _pack_factor(hw: int, c: int) -> int | None:
    """Smallest k with (k*c) % 128 == 0, hw % k == 0 and (hw/k) % 8 == 0
    (the JAX kernel's lane packing)."""
    k = _LANE // math.gcd(c, _LANE)
    if hw % k or (hw // k) % 8:
        return None
    return k


def supported(h: int, w: int, c: int, groups: int) -> bool:
    """Whether the JAX kernel, and so this one, takes the shape: the chain's
    route is chosen from this, before any launch."""
    return c % groups == 0 and _pack_factor(h * w, c) is not None


def cluster_smem_bytes(part_channels: int, iters: int, itemsize: int) -> int:
    """Shared memory of one C′ cluster-route block: x (its own type) and dz
    (f32) for ``iters`` rows of 8 channels per thread, the row sums, the
    part's sums, its finalize and parameters (``cluster_smem_bytes`` in
    the source)."""
    return (iters * CLUSTER_THREADS * 8 * (itemsize + 4)
            + 4 * (8 * (CLUSTER_THREADS + 1) + CLUSTER_THREADS + 16 * part_channels))


def fwd_cluster_smem_bytes(part_channels: int, iters: int, itemsize: int) -> int:
    """Shared memory of one C cluster-route block: x alone (its own type)
    for ``iters`` rows of 8 channels per thread, the row sums, the part's
    sums, its coefficients and group statistics (``fwd_cluster_smem_bytes``
    in the source)."""
    return (iters * CLUSTER_THREADS * 8 * itemsize
            + 4 * (8 * (CLUSTER_THREADS + 1) + CLUSTER_THREADS + 7 * part_channels))


def blocks_per_sm(smem: int, register_blocks: int) -> int:
    """Cluster-route blocks of ``smem`` bytes that an SM's shared memory,
    threads and (``register_blocks`` by the kernel's launch bounds)
    registers hold at once."""
    return min(register_blocks, THREADS_PER_SM // CLUSTER_THREADS,
               SMEM_PER_SM // (smem + SMEM_RESERVED))


def cluster_layouts(hw: int, c: int, groups: int, itemsize: int, smem_bytes=cluster_smem_bytes,
                    register_blocks: int = BWD_REGISTER_BLOCKS) -> list[dict]:
    """Every cluster layout of a (B, HW, C) chain with G groups whose block
    fits in shared memory (``smem_bytes(part_channels, iters, itemsize)``
    a block; by default C′'s count and register limit), C′'s preference
    first; empty where C is not a multiple of 8.

    One thread-block cluster of ``cluster`` blocks per batch element and
    channel part of ``part_channels`` channels (whole groups) holds the
    part on chip; each block takes ``rows`` pixel rows in ``iters``
    iterations, ``smem`` bytes, and an SM holds ``blocks_per_sm`` such
    blocks. C′ prefers, in order: blocks that fit two to an SM; pixel rows
    of 64 bytes or more, else of a 32-byte sector; the smallest cluster;
    the widest part.
    """
    cpg = c // groups
    found = []
    if c % 8 == 0:
        for cp in range(8, c + 1, 8):
            if c % cp or cp % cpg or cp // 8 > CLUSTER_THREADS:
                continue
            for cs in (1, 2, 4, MAX_CLUSTER):
                rows = -(-hw // cs)
                iters = -(-rows // (CLUSTER_THREADS // (cp // 8)))
                smem = smem_bytes(cp, iters, itemsize)
                row_bytes = cp * itemsize
                width = 0 if row_bytes >= 64 else 1 if row_bytes >= 32 else 2
                if smem <= SMEM_PER_BLOCK:
                    found.append(((smem > SMEM_TWO_PER_SM, width, cs, -cp),
                                  {"route": "cluster", "part_channels": cp, "cluster": cs,
                                   "rows": rows, "iters": iters, "smem": smem,
                                   "blocks_per_sm": blocks_per_sm(smem, register_blocks)}))
    return [layout for _, layout in sorted(found, key=lambda kv: kv[0])]


@functools.lru_cache(maxsize=None)
def cluster_plan(hw: int, c: int, groups: int, itemsize: int) -> dict | None:
    """C′'s cluster layout of a shape (the first of :func:`cluster_layouts`),
    or None where no cluster holds the slab (C not a multiple of 8, or more
    rows than 8 blocks' shared memory takes). The returned dict is shared:
    copy it to change it."""
    layouts = cluster_layouts(hw, c, groups, itemsize)
    return layouts[0] if layouts else None


def _fwd_key(layout: dict, itemsize: int) -> tuple:
    """C's preference among layouts, in order: pixel rows of a 32-byte
    sector or more; three or more blocks an SM; rows of 64 bytes or more;
    more blocks an SM; the smallest cluster; the widest part."""
    row_bytes = layout["part_channels"] * itemsize
    held = layout["blocks_per_sm"]
    return (row_bytes < 32, held < 3, row_bytes < 64, -held, layout["cluster"],
            -layout["part_channels"])


@functools.lru_cache(maxsize=None)
def fwd_plan(hw: int, c: int, groups: int, itemsize: int) -> dict:
    """How kernel C covers a (B, HW, C) chain with G groups, chosen before
    the launch: the cluster route (x read once into shared memory, one
    launch) on the layout :func:`_fwd_key` prefers among C's
    :func:`cluster_layouts`, where that layout has pixel rows of 32 bytes
    or more and three or more blocks an SM; else ``"three_pass"``
    (statistics, finalize and apply in separate launches, x read twice),
    which also takes C not a multiple of 8 and slabs no cluster holds.

    The rule follows chip_smoke.py's timings of every cluster layout and
    the three passes at each chain shape of the flagship U-Net on an H100
    (PERF.md §6): the preferred layout ran faster than the three passes at
    all 17 shapes, and within 11% of the fastest layout measured at each;
    layouts with 16-byte rows (a sector split between two clusters) or one
    block an SM (a cluster's life of load, sums, exchange and apply then
    idles the memory) ran slower than the three passes. The returned dict
    is shared: copy it to change it.
    """
    layouts = cluster_layouts(hw, c, groups, itemsize, fwd_cluster_smem_bytes,
                              FWD_REGISTER_BLOCKS)
    plan = min(layouts, key=lambda layout: _fwd_key(layout, itemsize), default=None)
    if plan is None or plan["part_channels"] * itemsize < 32 or plan["blocks_per_sm"] < 3:
        return THREE_PASS
    return plan


@functools.lru_cache(maxsize=None)
def bwd_plan(hw: int, c: int, groups: int, itemsize: int) -> dict:
    """How kernel C′ covers a (B, HW, C) chain with G groups, chosen before
    the launch: the cluster route (:func:`cluster_plan`) for bf16 x where a
    cluster holds the slab in pixel rows of 64 bytes or more, else
    ``"two_pass"`` (statistics and dx in separate passes over x and g).

    The choice follows chip_smoke.py's timings of both routes at every
    chain shape of the flagship U-Net on an H100 (PERF.md §6): bf16
    clusters with rows of 64 bytes or more ran faster than two passes or
    as fast; narrower rows (48 bytes at 64x64x192, 16 at the 128x128
    chains, whose slab 8 blocks hold only in 8-channel parts) and f32 x,
    whose slab takes twice the shared memory, ran slower. The returned
    dict is shared: copy it to change it.
    """
    plan = cluster_plan(hw, c, groups, itemsize) if itemsize == 2 else None
    if plan is None or plan["part_channels"] * itemsize < 64:
        return TWO_PASS
    return plan


def gn_keep(shape, seed2: torch.Tensor, p_drop: float) -> torch.Tensor:
    """The keep mask (bool, (B, H, W, C)): the hash of the NHWC index inside
    each batch element, salted with the batch index."""
    b, m = shape[0], math.prod(shape[1:])
    pos = torch.arange(m, dtype=torch.int64, device=seed2.device)[None, :]
    salt = torch.arange(b, dtype=torch.int64, device=seed2.device)[:, None]
    return (hash_uniform(pos, seed2, salt) >= np.float32(p_drop)).reshape(shape)


def slab_seed(seed2: torch.Tensor, batch_offset: int, row_offset: int = 0) -> torch.Tensor:
    """C's and C′'s (2,) int32 seed words for a block whose first batch row
    is ``batch_offset`` in the global batch and whose first element inside
    an item is ``row_offset`` (h0 * W * C for a block of image rows from
    row h0): ``gn_keep`` of the block under them is the global elements'
    ``gn_keep`` under ``seed2``. Both offsets 0: ``seed2`` itself."""
    if batch_offset == 0 and row_offset == 0:
        return seed2
    words = seed2.to(torch.int64) & _MASK32
    words[1] = (words[1] + (batch_offset * 40503 + row_offset) % 2**32) & _MASK32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _drop_scale(p_drop: float) -> np.float32:
    return np.float32(1.0 / (1.0 - p_drop))


def _per_channel(v: torch.Tensor, c: int) -> torch.Tensor:
    """(B, G) group values repeated over each group's channels: (B, C)."""
    return v.repeat_interleave(c // v.shape[1], dim=1)


def _coefs(mean, rstd, gamma, beta, scale, shift):
    """Per (batch, channel): mean, rstd, p, q, scale + 1, a and b of
    z = x*a + b."""
    c = gamma.shape[0]
    mean_c, rstd_c = _per_channel(mean, c), _per_channel(rstd, c)
    p = rstd_c * gamma
    q = beta - mean_c * p
    sc1 = scale + 1.0
    return mean_c, rstd_c, p, q, sc1, p * sc1, q * sc1 + shift


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, :]


def _stats(x, groups: int, eps: float):
    """mean and rstd (B, G) of the whole chain x (B, H, W, C)."""
    b, h, w, c = x.shape
    n = float(h * w * (c // groups))
    xg = x.reshape(b, h * w, groups, c // groups)
    s1 = xg.sum(dim=(1, 3), dtype=torch.float32)
    s2 = (xg * xg).sum(dim=(1, 3), dtype=torch.float32)
    mean = s1 / n
    return mean, torch.rsqrt(s2 / n - mean * mean + eps)


def _apply(x, mean, rstd, gamma, beta, scale, shift, seed2, p_drop: float, silu: bool):
    """y in x's dtype from the statistics."""
    *_, a, bb = _coefs(mean, rstd, gamma, beta, scale, shift)
    z = x.float() * _bcast(a) + _bcast(bb)
    out = z * torch.sigmoid(z) if silu else z
    if p_drop > 0.0:
        keep = gn_keep(x.shape, seed2, p_drop)
        scaled = out * torch.tensor(_drop_scale(p_drop), device=x.device)
        out = torch.where(keep, scaled, torch.zeros((), device=x.device))
    return out.to(x.dtype)


def gn_film_silu_dropout_plain(x, gamma, beta, scale, shift, seed2, groups: int, eps: float,
                       p_drop: float, silu: bool):
    """The plain PyTorch forward: (y in x's dtype, mean (B, G), rstd (B, G))."""
    mean, rstd = _stats(x, groups, eps)
    return (_apply(x, mean, rstd, gamma, beta, scale, shift, seed2, p_drop, silu),
            mean, rstd)


def _bwd_dz(x, g, coefs, seed2, p_drop: float, silu: bool):
    """(x in f32, dz = g * silu'(z), masked and scaled like the forward)."""
    a, bb = coefs[-2:]
    xf = x.float()
    dz = g.float()
    if silu:
        z = xf * _bcast(a) + _bcast(bb)
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    if p_drop > 0.0:
        keep = gn_keep(x.shape, seed2, p_drop)
        scaled = dz * torch.tensor(_drop_scale(p_drop), device=x.device)
        dz = torch.where(keep, scaled, torch.zeros((), device=x.device))
    return xf, dz


def _bwd_terms(s_dz, s_dzx, coefs):
    """(dshift, dscale, the dbeta terms du_s, the dgamma terms dux_hat), all
    (B, C), from the sums Sdz, Sdzx."""
    mean_c, rstd_c, p, q, sc1 = coefs[:5]
    return (s_dz, s_dzx * p + s_dz * q, s_dz * sc1,
            (s_dzx - mean_c * s_dz) * rstd_c * sc1)


def _bwd_dx(xf, dz, du_s, dux_hat, coefs, gamma, groups: int, n: float):
    """dx = dz*c1 + x*c2 + c3 (f32), c2 and c3 from the group means (over
    n elements) of the terms times gamma."""
    mean_c, rstd_c, _, _, sc1 = coefs[:5]
    b, c = du_s.shape

    def group_mean(v):
        return _per_channel(v.reshape(b, groups, c // groups).sum(dim=2) / n, c)

    m1 = group_mean(du_s * gamma)
    m2 = group_mean(dux_hat * gamma)
    c1 = rstd_c * gamma * sc1
    c2 = -(rstd_c * rstd_c) * m2
    c3 = rstd_c * (mean_c * rstd_c * m2 - m1)
    return dz * _bcast(c1) + xf * _bcast(c2) + _bcast(c3)


def gn_film_silu_dropout_bwd_plain(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups: int,
                       p_drop: float, silu: bool):
    """The plain PyTorch backward (the TPU kernel's formula): (dx in x's
    dtype, dgamma (C,), dbeta (C,), dscale (B, C), dshift (B, C))."""
    b, h, w, c = x.shape
    n = float(h * w * (c // groups))
    coefs = _coefs(mean, rstd, gamma, beta, scale, shift)
    xf, dz = _bwd_dz(x, g, coefs, seed2, p_drop, silu)
    s_dz = dz.sum(dim=(1, 2))                                  # (B, C)
    s_dzx = (dz * xf).sum(dim=(1, 2))
    dshift, dscale, du_s, dux_hat = _bwd_terms(s_dz, s_dzx, coefs)
    dx = _bwd_dx(xf, dz, du_s, dux_hat, coefs, gamma, groups, n)
    return dx.to(x.dtype), dux_hat.sum(dim=0), du_s.sum(dim=0), dscale, dshift


# ---------------------------------------------------------------------------
# The split route: a block of rows, its statistics summed by the caller
# ---------------------------------------------------------------------------

def _count(x: torch.Tensor, groups: int, height: int) -> float:
    """The elements of a group over the image's ``height`` rows."""
    _, _, w, c = x.shape
    return float(height * w * (c // groups))


def _gathered(blocks: list[torch.Tensor], h0: int, height: int, reduce) -> torch.Tensor:
    """The image's values of each (B, h, W, C) block tensor, in f32: (len,
    B, height, W, C), the blocks placed at rows h0.. among zeros and
    summed over the ranks in place by ``reduce`` (each element one block's
    value plus zeros: exact)."""
    b, h, w, c = blocks[0].shape
    out = torch.zeros((len(blocks), b, height, w, c), dtype=torch.float32,
                      device=blocks[0].device)
    for i, t in enumerate(blocks):
        out[i, :, h0:h0 + h] = t
    reduce(out)
    return out


def gn_split_fwd_plain(x, gamma, beta, scale, shift, seed2, groups: int, eps: float,
                       p_drop: float, silu: bool, height: int, reduce, h0: int):
    """Split C's plain version: the image gathered (the block's x placed at
    its rows, from ``h0``, among zero rows of the image's ``height``,
    summed over the ranks by ``reduce``), its statistics those of the
    whole chain's plain version, and the block's y: (y, mean (B, G), rstd
    (B, G))."""
    image = _gathered([x], h0, height, reduce)[0].to(x.dtype)
    mean, rstd = _stats(image, groups, eps)
    return (_apply(x, mean, rstd, gamma, beta, scale, shift, seed2, p_drop, silu),
            mean, rstd)


def gn_split_bwd_plain(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups: int,
                       p_drop: float, silu: bool, height: int, reduce, h0: int):
    """Split C′'s plain version: the block's sums of dz and dz*x give its
    dgamma, dbeta, dscale and dshift; dz and dz*x gathered over the image
    as in :func:`gn_split_fwd_plain` give the whole chain's sums, and dx
    from them: (dx, dgamma, dbeta, dscale, dshift)."""
    coefs = _coefs(mean, rstd, gamma, beta, scale, shift)
    xf, dz = _bwd_dz(x, g, coefs, seed2, p_drop, silu)
    dzx = dz * xf
    dshift, dscale, du_s, dux_hat = _bwd_terms(dz.sum(dim=(1, 2)), dzx.sum(dim=(1, 2)), coefs)
    dgamma, dbeta = dux_hat.sum(dim=0), du_s.sum(dim=0)
    image = _gathered([dz, dzx], h0, height, reduce)
    _, _, du_s, dux_hat = _bwd_terms(image[0].sum(dim=(1, 2)), image[1].sum(dim=(1, 2)), coefs)
    dx = _bwd_dx(xf, dz, du_s, dux_hat, coefs, gamma, groups, _count(x, groups, height))
    return dx.to(x.dtype), dgamma, dbeta, dscale, dshift


def gn_split_fwd(x, gamma, beta, scale, shift, seed2, groups: int, eps: float, p_drop: float,
                 silu: bool, height: int, reduce, h0: int):
    """Split C on a block of rows (its first row ``h0`` of the image's
    ``height``): (y, mean, rstd) without autograd, the statistics over
    the image after ``reduce`` (in place: the kernels' (2, B, T, C) f32
    partial sums, the plain version's gathered image). The plain version
    for CPU tensors, kernel C's split entries for CUDA tensors."""
    args = (x, gamma, beta, scale, shift, seed2)
    if all(t.device.type == "cpu" for t in args):
        return gn_split_fwd_plain(*args, groups, eps, p_drop, silu, height, reduce, h0)
    return _launch_split_fwd(*args, groups, eps, p_drop, silu, height, reduce)


def gn_split_bwd(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups: int,
                 p_drop: float, silu: bool, height: int, reduce, h0: int):
    """Split C′ on a block of rows (its first row ``h0`` of the image's
    ``height``): (dx, dgamma, dbeta, dscale, dshift), the parameter terms
    the block's, dx from the sums after ``reduce``. The plain version for
    CPU tensors, kernel C′'s split entries for CUDA tensors."""
    args = (x, g, gamma, beta, scale, shift, seed2, mean, rstd)
    if all(t.device.type == "cpu" for t in args):
        return gn_split_bwd_plain(*args, groups, p_drop, silu, height, reduce, h0)
    return _launch_split_bwd(*args, groups, p_drop, silu, height, reduce)


def gn_film_silu_dropout_fwd(x, gamma, beta, scale, shift, seed2, groups: int, eps: float,
                             p_drop: float, silu: bool):
    """(y, mean, rstd) without autograd: the plain version for CPU tensors,
    kernel C for CUDA tensors."""
    args = (x, gamma, beta, scale, shift, seed2)
    if all(t.device.type == "cpu" for t in args):
        return gn_film_silu_dropout_plain(*args, groups, eps, p_drop, silu)
    return _launch(*args, groups, eps, p_drop, silu)


def gn_film_silu_dropout_bwd(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups: int,
                             p_drop: float, silu: bool):
    """(dx, dgamma, dbeta, dscale, dshift): the plain backward for CPU
    tensors, kernel C′ for CUDA tensors."""
    args = (x, g, gamma, beta, scale, shift, seed2, mean, rstd)
    if all(t.device.type == "cpu" for t in args):
        return gn_film_silu_dropout_bwd_plain(*args, groups, p_drop, silu)
    return _launch_bwd(*args, groups, p_drop, silu)


gn_film_silu_dropout_bwd.launches = 0
gn_split_fwd.launches = 0
gn_split_bwd.launches = 0


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu, rows):
        args = (x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu)
        if rows is None:
            y, mean, rstd = gn_film_silu_dropout_fwd(*args)
        else:
            y, mean, rstd = gn_split_fwd(*args, *_split(x, rows))
        ctx.save_for_backward(x, gamma, beta, scale, shift, seed2, mean, rstd)
        ctx.consts = (groups, p_drop, silu)
        ctx.rows = rows
        return y

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        args = (x, g.contiguous(), *rest, *ctx.consts)
        if ctx.rows is None:
            grads = gn_film_silu_dropout_bwd(*args)
        else:
            grads = gn_split_bwd(*args, *_split(x, ctx.rows))
        return (*grads, None, None, None, None, None, None)


def _split(x: torch.Tensor, rows) -> tuple[int, object, int]:
    """(the image's height, the in-place sum over the ranks, the block's
    first row) of a block of rows of a chain."""
    h = x.shape[1]
    return rows.whole(h), rows.sum_, rows.first(h)


def gn_film_silu_dropout(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, seed2: torch.Tensor,
                         groups: int, eps: float, p_drop: float, silu: bool,
                         rows=None) -> torch.Tensor:
    """dropout(silu((gn(x)*gamma + beta)*(scale+1) + shift)), y in x's dtype;
    differentiable in x, gamma, beta, scale and shift (analytic backward).

    x (B, H, W, C) NHWC; gamma/beta (C,), scale/shift (B, C) f32 (zeros for
    plain GN + SiLU); seed2 (2,) int32 dropout seed words (read only when
    p_drop > 0). CPU tensors take the plain versions; CUDA tensors launch
    kernels C and C′ (f32 or bf16 x, contiguous, a ``supported`` shape) or
    raise. ``rows`` (``parallel.spatial.Rows``): x is this rank's block of
    rows, and C and C′ run split around the sum of their statistics over
    the ranks (the seed words are the caller's, shifted to the block by
    :func:`slab_seed`); the dgamma, dbeta, dscale and dshift they return
    are the block's, to be summed with the other parameter gradients.
    """
    return _Chain.apply(x, gamma, beta, scale, shift, seed2, int(groups), float(eps),
                        float(p_drop), bool(silu), rows)


gn_film_silu_dropout.launches = 0


def _check(x, params, groups: int, what: str) -> None:
    """Device, dtype, shape and layout checks before a launch."""
    if x.device.type != "cuda" or any(t.device != x.device for t in params.values()):
        raise ValueError(f"{what}: x on {x.device}, "
                         + ", ".join(f"{k} on {t.device}" for k, t in params.items())
                         + "; the kernel needs all on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: the kernel takes f32 or bf16 x, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if not supported(h, w, c, groups):
        raise ValueError(f"{what}: (H, W, C, G) = {(h, w, c, groups)} is not supported; the "
                         "layer takes the composed route for it")
    if not 1 <= b <= 65535 or 2 * c + 2 * groups > 12288:
        raise ValueError(f"{what}: B={b}, C={c} outside the kernel's limits")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            f"{what}: x (strides {x.stride()}) must be NHWC contiguous and 16-byte aligned: "
            "pass the NHWC view of a channels_last activation")
    want = {"gamma": ((c,), torch.float32), "beta": ((c,), torch.float32),
            "scale": ((b, c), torch.float32), "shift": ((b, c), torch.float32),
            "seed2": ((2,), torch.int32), "mean": ((b, groups), torch.float32),
            "rstd": ((b, groups), torch.float32), "g": (tuple(x.shape), x.dtype)}
    for name, t in params.items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {shape} {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if params.get("g") is not None and params["g"].data_ptr() % 16:
        raise ValueError(f"{what}: g must be 16-byte aligned")


def _work(x: torch.Tensor, lib) -> torch.Tensor:
    """Scratch of C's three-pass route and of C′'s two-pass route."""
    b, h, w, c = x.shape
    ntiles = lib.fused_gn_tiles(h * w, c)
    return torch.empty(7 * b * c + 2 * b * ntiles * c, dtype=torch.float32, device=x.device)


def _launch(x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu, plan=None):
    """Kernel C on ``plan`` (a :func:`fwd_plan` dict or one of C's
    :func:`cluster_layouts`; by default the shape's :func:`fwd_plan`)."""
    _check(x, dict(gamma=gamma, beta=beta, scale=scale, shift=shift, seed2=seed2), groups,
           "gn_film_silu_dropout")
    b, h, w, c = x.shape
    plan = plan or fwd_plan(h * w, c, groups, x.element_size())
    lib = _build.library()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        work = None if plan["route"] == "cluster" else _work(x, lib)
        err = lib.fused_gn_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), seed2.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), None if work is None else work.data_ptr(), b, h * w, c, groups,
            float(np.float32(eps)), float(np.float32(p_drop)), float(_drop_scale(p_drop)),
            int(silu), int(x.dtype == torch.bfloat16), int(plan["route"] == "cluster"),
            plan.get("part_channels", 0), plan.get("cluster", 0), plan.get("iters", 0),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_gn_fwd")
    gn_film_silu_dropout.launches += 1
    return y, mean, rstd


def _launch_bwd(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups, p_drop, silu,
                plan=None):
    """Kernel C′ on ``plan`` (a :func:`bwd_plan` or :func:`cluster_plan`
    dict; by default the shape's :func:`bwd_plan`)."""
    _check(x, dict(g=g, gamma=gamma, beta=beta, scale=scale, shift=shift, seed2=seed2,
                   mean=mean, rstd=rstd), groups, "gn_film_silu_dropout backward")
    b, h, w, c = x.shape
    plan = plan or bwd_plan(h * w, c, groups, x.element_size())
    cluster = plan["route"] == "cluster"
    lib = _build.library()
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
        dbeta = torch.empty_like(dgamma)
        dscale = torch.empty((b, c), dtype=torch.float32, device=x.device)
        dshift = torch.empty_like(dscale)
        # the cluster route: the (2, B, C) dgamma/dbeta terms and an arrival count
        work = (torch.empty(2 * b * c + 1, dtype=torch.float32, device=x.device) if cluster
                else _work(x, lib))
        err = lib.fused_gn_bwd(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), seed2.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dscale.data_ptr(),
            dshift.data_ptr(), work.data_ptr(), b, h * w, c, groups,
            float(np.float32(p_drop)), float(_drop_scale(p_drop)), int(silu),
            int(x.dtype == torch.bfloat16), int(cluster), plan.get("part_channels", 0),
            plan.get("cluster", 0), plan.get("iters", 0),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_gn_bwd")
    gn_film_silu_dropout_bwd.launches += 1
    return dx, dgamma, dbeta, dscale, dshift


def _param_ptrs(*params) -> tuple[int, ...]:
    return tuple(t.data_ptr() for t in params)


def _launch_split_fwd(x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu, height,
                      reduce):
    """Split C: ``fused_gn_fwd_stats``, ``reduce`` on the partials, then
    ``fused_gn_fwd_apply`` with the count of the image's ``height`` rows;
    the block's shape must be ``supported``."""
    _check(x, dict(gamma=gamma, beta=beta, scale=scale, shift=shift, seed2=seed2), groups,
           "gn_film_silu_dropout (split)")
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial = torch.empty((2, b, lib.fused_gn_tiles(h * w, c), c), dtype=torch.float32,
                              device=x.device)
        err = lib.fused_gn_fwd_stats(x.data_ptr(), partial.data_ptr(), b, h * w, c, bf16, stream)
    _build.check(err, "fused_gn_fwd_stats")
    reduce(partial)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        coef = torch.empty(2 * b * c, dtype=torch.float32, device=x.device)
        err = lib.fused_gn_fwd_apply(
            x.data_ptr(), partial.data_ptr(), *_param_ptrs(gamma, beta, scale, shift, seed2),
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), coef.data_ptr(), b, h * w, c,
            groups, float(np.float32(_count(x, groups, height))), float(np.float32(eps)), float(np.float32(p_drop)),
            float(_drop_scale(p_drop)), int(silu), bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_gn_fwd_apply")
    gn_film_silu_dropout.launches += 1
    gn_split_fwd.launches += 1
    return y, mean, rstd


def _launch_split_bwd(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups, p_drop,
                      silu, height, reduce):
    """Split C′: ``fused_gn_bwd_stats`` (the block's partials and parameter
    terms), ``reduce`` on the partials, then ``fused_gn_bwd_dx`` with the
    count of the image's ``height`` rows."""
    _check(x, dict(g=g, gamma=gamma, beta=beta, scale=scale, shift=shift, seed2=seed2,
                   mean=mean, rstd=rstd), groups, "gn_film_silu_dropout backward (split)")
    b, h, w, c = x.shape
    bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.library()
    ptrs = _param_ptrs(gamma, beta, scale, shift, seed2)
    consts = (float(np.float32(p_drop)), float(_drop_scale(p_drop)), int(silu), bf16)
    with torch.cuda.device(x.device):
        partial = torch.empty((2, b, lib.fused_gn_tiles(h * w, c), c), dtype=torch.float32,
                              device=x.device)
        coef = torch.empty(9 * b * c, dtype=torch.float32, device=x.device)
        dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
        dbeta = torch.empty_like(dgamma)
        dscale = torch.empty((b, c), dtype=torch.float32, device=x.device)
        dshift = torch.empty_like(dscale)
        err = lib.fused_gn_bwd_stats(
            x.data_ptr(), g.data_ptr(), *ptrs, mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr(), coef.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            dscale.data_ptr(), dshift.data_ptr(), b, h * w, c, groups, *consts,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_gn_bwd_stats")
    reduce(partial)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        err = lib.fused_gn_bwd_dx(
            x.data_ptr(), g.data_ptr(), *ptrs, mean.data_ptr(), rstd.data_ptr(),
            partial.data_ptr(), coef.data_ptr(), dx.data_ptr(), b, h * w, c, groups,
            float(np.float32(_count(x, groups, height))), *consts, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_gn_bwd_dx")
    gn_film_silu_dropout_bwd.launches += 1
    gn_split_bwd.launches += 1
    return dx, dgamma, dbeta, dscale, dshift
