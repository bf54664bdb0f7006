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
seed words, as the JAX ``_vjp_fwd`` saves them.

Kernel C′ follows a plan made here per shape, before the launch
(:func:`bwd_plan`): for bf16 x, one thread-block cluster per batch element
and channel part, which keeps the part's x and dz in shared memory so x
and g are read once; for f32 x and the shapes no cluster holds in rows
of 64 bytes or more, two passes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from probunet_tpu_torch.ops.kernels import _build
from probunet_tpu_torch.ops.kernels.dropout import hash_uniform

SOURCE = "probunet_tpu_torch/csrc/fused_gn.cu"
REPLACES = "probunet_tpu/ops/pallas/fused_gn.py:247"
REPLACES_BWD = "probunet_tpu/ops/pallas/fused_gn.py:282"

_LANE = 128

# Kernel C′'s cluster route (csrc/fused_gn.cu:gn_bwd_cluster_kernel) on the
# H100: a block's threads, the most blocks of a cluster (the portable 8),
# the most shared memory a block takes (227 KB) less room for its static
# part, and the budget that leaves two blocks on each SM's 228 KB.
CLUSTER_THREADS = 256
MAX_CLUSTER = 8
SMEM_PER_BLOCK = 227 * 1024 - 1024
SMEM_TWO_PER_SM = 112 * 1024
TWO_PASS = {"route": "two_pass"}


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
    """Shared memory of one cluster-route block: x (its own type) and dz
    (f32) for ``iters`` rows of 8 channels per thread, the row sums, the
    part's sums, its finalize and parameters (``cluster_smem_bytes`` in
    the source)."""
    return (iters * CLUSTER_THREADS * 8 * (itemsize + 4)
            + 4 * (8 * (CLUSTER_THREADS + 1) + CLUSTER_THREADS + 16 * part_channels))


@functools.lru_cache(maxsize=None)
def cluster_plan(hw: int, c: int, groups: int, itemsize: int) -> dict | None:
    """The cluster route's layout for a (B, HW, C) chain with G groups, or
    None where no cluster holds the slab (C not a multiple of 8, or more
    rows than 8 blocks' shared memory takes).

    One thread-block cluster of ``cluster`` blocks per batch element and
    channel part of ``part_channels`` channels (whole groups) holds the
    part's x and dz on chip, so x and g are read once; each block takes
    ``rows`` pixel rows in ``iters`` iterations and ``smem`` bytes.
    Preferred, in order: blocks that fit two to an SM; pixel rows of 64
    bytes or more, else of a 32-byte sector; the smallest cluster; the
    widest part. The returned dict is shared: copy it to change it.
    """
    cpg = c // groups
    best = None
    if c % 8 == 0:
        for cp in range(8, c + 1, 8):
            if c % cp or cp % cpg or cp // 8 > CLUSTER_THREADS:
                continue
            for cs in (1, 2, 4, MAX_CLUSTER):
                rows = -(-hw // cs)
                iters = -(-rows // (CLUSTER_THREADS // (cp // 8)))
                smem = cluster_smem_bytes(cp, iters, itemsize)
                row_bytes = cp * itemsize
                width = 0 if row_bytes >= 64 else 1 if row_bytes >= 32 else 2
                key = (smem > SMEM_TWO_PER_SM, width, cs, -cp)
                if smem <= SMEM_PER_BLOCK and (best is None or key < best[0]):
                    best = (key, {"route": "cluster", "part_channels": cp, "cluster": cs,
                                  "rows": rows, "iters": iters, "smem": smem})
    return None if best is None else best[1]


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


def gn_film_silu_dropout_plain(x, gamma, beta, scale, shift, seed2, groups: int, eps: float,
                       p_drop: float, silu: bool):
    """The plain PyTorch forward: (y in x's dtype, mean (B, G), rstd (B, G))."""
    b, h, w, c = x.shape
    n = float(h * w * (c // groups))
    xg = x.reshape(b, h * w, groups, c // groups)
    s1 = xg.sum(dim=(1, 3), dtype=torch.float32)
    s2 = (xg * xg).sum(dim=(1, 3), dtype=torch.float32)
    mean = s1 / n
    rstd = torch.rsqrt(s2 / n - mean * mean + eps)
    *_, a, bb = _coefs(mean, rstd, gamma, beta, scale, shift)
    z = x.float() * _bcast(a) + _bcast(bb)
    out = z * torch.sigmoid(z) if silu else z
    if p_drop > 0.0:
        keep = gn_keep(x.shape, seed2, p_drop)
        scaled = out * torch.tensor(_drop_scale(p_drop), device=x.device)
        out = torch.where(keep, scaled, torch.zeros((), device=x.device))
    return out.to(x.dtype), mean, rstd


def gn_film_silu_dropout_bwd_plain(x, g, gamma, beta, scale, shift, seed2, mean, rstd, groups: int,
                       p_drop: float, silu: bool):
    """The plain PyTorch backward (the TPU kernel's formula): (dx in x's
    dtype, dgamma (C,), dbeta (C,), dscale (B, C), dshift (B, C))."""
    b, h, w, c = x.shape
    n = float(h * w * (c // groups))
    mean_c, rstd_c, p, q, sc1, a, bb = _coefs(mean, rstd, gamma, beta, scale, shift)
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
    s_dz = dz.sum(dim=(1, 2))                                  # (B, C)
    s_dzx = (dz * xf).sum(dim=(1, 2))
    dshift = s_dz
    dscale = s_dzx * p + s_dz * q
    du_s = s_dz * sc1
    dux_hat = (s_dzx - mean_c * s_dz) * rstd_c * sc1

    def group_mean(v):
        return _per_channel(v.reshape(b, groups, c // groups).sum(dim=2) / n, c)

    m1 = group_mean(du_s * gamma)
    m2 = group_mean(dux_hat * gamma)
    c1 = rstd_c * gamma * sc1
    c2 = -(rstd_c * rstd_c) * m2
    c3 = rstd_c * (mean_c * rstd_c * m2 - m1)
    dx = dz * _bcast(c1) + xf * _bcast(c2) + _bcast(c3)
    return dx.to(x.dtype), dux_hat.sum(dim=0), du_s.sum(dim=0), dscale, dshift


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


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu):
        y, mean, rstd = gn_film_silu_dropout_fwd(x, gamma, beta, scale, shift, seed2, groups,
                                                 eps, p_drop, silu)
        ctx.save_for_backward(x, gamma, beta, scale, shift, seed2, mean, rstd)
        ctx.consts = (groups, p_drop, silu)
        return y

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        grads = gn_film_silu_dropout_bwd(x, g.contiguous(), *rest, *ctx.consts)
        return (*grads, None, None, None, None, None)


def gn_film_silu_dropout(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         scale: torch.Tensor, shift: torch.Tensor, seed2: torch.Tensor,
                         groups: int, eps: float, p_drop: float, silu: bool) -> torch.Tensor:
    """dropout(silu((gn(x)*gamma + beta)*(scale+1) + shift)), y in x's dtype;
    differentiable in x, gamma, beta, scale and shift (analytic backward).

    x (B, H, W, C) NHWC; gamma/beta (C,), scale/shift (B, C) f32 (zeros for
    plain GN + SiLU); seed2 (2,) int32 dropout seed words (read only when
    p_drop > 0). CPU tensors take the plain versions; CUDA tensors launch
    kernels C and C′ (f32 or bf16 x, contiguous, a ``supported`` shape) or
    raise.
    """
    return _Chain.apply(x, gamma, beta, scale, shift, seed2, int(groups), float(eps),
                        float(p_drop), bool(silu))


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
    """Scratch of C and of C′'s two-pass route."""
    b, h, w, c = x.shape
    ntiles = lib.fused_gn_tiles(h * w, c)
    return torch.empty(7 * b * c + 2 * b * ntiles * c, dtype=torch.float32, device=x.device)


def _launch(x, gamma, beta, scale, shift, seed2, groups, eps, p_drop, silu):
    _check(x, dict(gamma=gamma, beta=beta, scale=scale, shift=shift, seed2=seed2), groups,
           "gn_film_silu_dropout")
    b, h, w, c = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        work = _work(x, lib)
        err = lib.fused_gn_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), seed2.data_ptr(), y.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), work.data_ptr(), b, h * w, c, groups,
            float(np.float32(eps)), float(np.float32(p_drop)), float(_drop_scale(p_drop)),
            int(silu), int(x.dtype == torch.bfloat16),
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
