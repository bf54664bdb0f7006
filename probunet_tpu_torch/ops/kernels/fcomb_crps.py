"""Fused Fcomb decode + CRPS terms: CUDA kernel (``csrc/fcomb_crps.cu``)
and plain version.

Port of ``probunet_tpu/ops/pallas/fcomb_crps.py``: forward (kernel A)
and analytic backward (kernel A′), both in ``csrc/fcomb_crps.cu``. The
afCRPS ELBO's reconstruction term is CRPS(fcomb-decoded ensemble,
target); :func:`fcomb_crps_terms` computes its two per-batch sums straight
from the layer-0 projections, per member m and pixel p:

    h0 = relu(feat[:, p] + z[:, m]);  h1 = relu(W1^T h0 + b1);
    x  = W2^T h1 + b2

without storing the (B, M, H, W, K) ensemble or the hiddens. The layer-0
split projections (``feats @ W0f`` and ``zs @ W0z + b0``) stay
``torch.matmul`` outside the kernel, which autograd differentiates, as the
JAX package leaves them to XLA.

:func:`fcomb_crps_terms` is a ``torch.autograd.Function``. Its backward,
given (g1, g2) per batch element, recomputes h0/h1 per member and pixel
and returns dfeat, dz, dW1, db1, dW2, db2 and (when asked for) dy:

    dx_m = g1 sign(x_m - y) + g2 sum_{k != m} sign(x_m - x_k)
    dh1 = W2 dx_m;  da1 = dh1 (h1 > 0);  dh0 = W1 da1;  du = dh0 (h0 > 0)
    dfeat = sum_m du;  dz_m = sum_p du;  dW1 = sum h0 da1^T;  db1 = sum da1
    dW2 = sum h1 dx^T;  db2 = sum dx;  dy = -g1 sum_m sign(x_m - y)

with ``_dot``/``_dot_t``'s rounding points: every product's operands
rounded to the compute dtype, sums in f32. On the card A and A′ are each
one of two kernels, picked from the compute dtype before the launch
(``FWD_KERNELS``, ``BWD_KERNELS``): bf16 operands run the C x C products
on the tensor cores, with one decode shared by A and A′; f32 operands
stay on the FP32 pipes. A′'s plain version is this
formula in torch with the same rounding points, not autograd through the
plain forward, whose bf16 rounding points differ.
"""

from __future__ import annotations

import ctypes

import torch

from probunet_tpu_torch.ops.kernels import _build
from probunet_tpu_torch.ops.kernels.afcrps import ensemble_crps_terms_plain
from probunet_tpu_torch.ops.losses import afcrps_from_terms, crps_from_terms
from probunet_tpu_torch.ops.precision import matmul_f32, round_to

SOURCE = "probunet_tpu_torch/csrc/fcomb_crps.cu"
REPLACES = "probunet_tpu/ops/pallas/fcomb_crps.py:264"
REPLACES_BWD = "probunet_tpu/ops/pallas/fcomb_crps.py:317"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernels A and A′ per compute dtype, and their ids in csrc/fcomb_crps.cu:
# bf16 operands run the C x C products on the tensor cores; f32 operands
# stay on the FP32 pipes (TF32 would move their rounding points)
FWD_KERNELS = {"bfloat16": "tensor_core", "float32": "fp32"}
BWD_KERNELS = {"bfloat16": "tensor_core", "float32": "fp32"}
_KERNEL_IDS = {"fp32": 0, "tensor_core": 1}
# the shapes kernels A and A′ are built for (kC, kMaxM, kMaxK and the
# grid's y limit in csrc/fcomb_crps.cu)
CHANNELS, MAX_MEMBERS, MAX_CLASSES, MAX_BATCH = 32, 32, 4, 65535


def supported(c: int, m: int, k: int, b: int) -> bool:
    """Whether kernels A and A′ take an Fcomb of width ``c``, ``m`` members,
    ``k`` classes and batch ``b``. ``ProbabilisticUNet.elbo`` chooses its
    reconstruction route from this before any launch: where it is False,
    the fused ELBO takes the unfused route (``Fcomb.ensemble`` and kernels
    B, B′, which take any M and B)."""
    return (c == CHANNELS and 2 <= m <= MAX_MEMBERS and 1 <= k <= MAX_CLASSES
            and 1 <= b <= MAX_BATCH)


def fcomb_crps_terms_plain(feat_t, z_t, w1, b1, w2, b2, target_t,
                           compute_dtype: str = "bfloat16"):
    """The plain PyTorch version: materialize the decode with the kernel's
    rounding points, then the plain CRPS terms."""
    cdt = _DTYPES[compute_dtype]
    b, c, p = feat_t.shape
    m = z_t.shape[2]
    h0 = torch.relu(feat_t[:, None] + z_t.permute(0, 2, 1)[..., None])  # (B, M, C, P)
    h1 = torch.relu(matmul_f32(w1.T, h0, cdt) + b1[:, None])
    x = matmul_f32(w2.T, h1, cdt) + b2[:, None]                        # (B, M, K, P)
    return ensemble_crps_terms_plain(x.reshape(b, m, -1),
                                     target_t.float().reshape(b, -1))


def fcomb_crps_terms_bwd_plain(feat_t, z_t, w1, b1, w2, b2, target_t, g1, g2,
                               compute_dtype: str = "bfloat16", need_dy: bool = True):
    """The plain analytic backward, one member at a time: (dfeat, dz, dW1,
    db1, dW2, db2, dy or None), all f32."""
    cdt = _DTYPES[compute_dtype]
    b, c, p = feat_t.shape
    m = z_t.shape[2]
    w1r, w2r = round_to(w1, cdt), round_to(w2, cdt)

    def hidden(j):
        h0 = torch.relu(feat_t + z_t[:, :, j:j + 1])                        # (B, C, P)
        return h0, torch.relu(torch.matmul(w1r.T, round_to(h0, cdt)) + b1[:, None])

    x = torch.stack([torch.matmul(w2r.T, round_to(hidden(j)[1], cdt)) + b2[:, None]
                     for j in range(m)], dim=1)                            # (B, M, K, P)
    s0 = torch.sign(x - target_t.float()[:, None])
    count = torch.zeros_like(s0)
    for d in range(1, m):
        s = torch.sign(x[:, : m - d] - x[:, d:])
        count[:, : m - d] += s
        count[:, d:] -= s
    g1 = g1.float()[:, None, None, None]
    dx_all = g1 * s0 + g2.float()[:, None, None, None] * count
    del x, count
    dfeat = torch.zeros_like(feat_t)
    dz = torch.zeros_like(z_t)
    dw1, db1 = torch.zeros_like(w1), torch.zeros_like(b1)
    dw2, db2 = torch.zeros_like(w2), torch.zeros_like(b2)
    for j in range(m):
        dx = dx_all[:, j]                                                 # (B, K, P)
        dxr = round_to(dx, cdt)
        h0, h1 = hidden(j)
        dw2 += torch.matmul(round_to(h1, cdt), dxr.transpose(1, 2)).sum(dim=0)
        db2 += dx.sum(dim=(0, 2))
        da1 = torch.matmul(w2r, dxr) * (h1 > 0)                           # (B, C, P)
        dw1 += torch.matmul(round_to(h0, cdt), round_to(da1, cdt).transpose(1, 2)).sum(dim=0)
        db1 += da1.sum(dim=(0, 2))
        du = torch.matmul(w1r, round_to(da1, cdt)) * (h0 > 0)
        dfeat += du
        dz[:, :, j] = du.sum(dim=2)
    dy = -g1[:, 0] * s0.sum(dim=1) if need_dy else None
    return dfeat, dz, dw1, db1, dw2, db2, dy


def fcomb_crps_terms_fwd(feat_t, z_t, w1, b1, w2, b2, target_t,
                         compute_dtype: str = "bfloat16"):
    """(t1, t2) without autograd: the plain version for CPU tensors, kernel
    A for CUDA tensors."""
    args = (feat_t, z_t, w1, b1, w2, b2, target_t)
    if all(a.device.type == "cpu" for a in args):
        return fcomb_crps_terms_plain(*args, compute_dtype)
    return _launch(args, FWD_KERNELS[compute_dtype])


def fcomb_crps_terms_bwd(feat_t, z_t, w1, b1, w2, b2, target_t, g1, g2,
                         compute_dtype: str = "bfloat16", need_dy: bool = True):
    """The seven gradients (dy None unless ``need_dy``): the plain backward
    for CPU tensors, kernel A′ for CUDA tensors."""
    args = (feat_t, z_t, w1, b1, w2, b2, target_t, g1, g2)
    if all(a.device.type == "cpu" for a in args):
        return fcomb_crps_terms_bwd_plain(*args, compute_dtype, need_dy)
    return _launch_bwd(args, BWD_KERNELS[compute_dtype], need_dy)


fcomb_crps_terms_bwd.launches = 0


class _Terms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_t, z_t, w1, b1, w2, b2, target_t, compute_dtype):
        ctx.save_for_backward(feat_t, z_t, w1, b1, w2, b2, target_t)
        ctx.compute_dtype = compute_dtype
        return fcomb_crps_terms_fwd(feat_t, z_t, w1, b1, w2, b2, target_t, compute_dtype)

    @staticmethod
    def backward(ctx, g1, g2):
        grads = fcomb_crps_terms_bwd(*ctx.saved_tensors, g1.contiguous(), g2.contiguous(),
                                     ctx.compute_dtype, need_dy=ctx.needs_input_grad[6])
        return (*grads, None)


def fcomb_crps_terms(feat_t, z_t, w1, b1, w2, b2, target_t,
                     compute_dtype: str = "bfloat16"):
    """(t1, t2) per batch element over the fcomb-decoded ensemble.

    feat_t (B, C, P) f32 — feats @ W0f, channels first (P = H*W);
    z_t (B, C, M) f32 — (zs @ W0z + b0) transposed;
    w1/b1 (C, C)/(C,), w2/b2 (C, K)/(K,) — fcomb layers 1-2;
    target_t (B, K, P) f32. Operands are rounded to ``compute_dtype``
    ("bfloat16" or "float32") with f32 accumulation. Differentiable
    (analytic backward).

    CPU tensors take the plain versions; CUDA tensors launch kernels A and
    A′ (the shapes of :func:`supported`) or raise.
    """
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(_DTYPES)}")
    return _Terms.apply(feat_t, z_t, w1, b1, w2, b2, target_t, compute_dtype)


fcomb_crps_terms.launches = 0


def _check(args, what: str):
    """Device, dtype, contiguity and shape checks; returns (B, C, P, M, K)."""
    feat_t, z_t, w1, b1, w2, b2, target_t = args[:7]
    dev = feat_t.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError(f"{what}: the kernel needs every operand on "
                         f"one CUDA device; got {[str(a.device) for a in args]}")
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError(f"{what}: the kernel takes f32 operands; got "
                         f"{[a.dtype for a in args]}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError(f"{what}: operands must be contiguous")
    if feat_t.dim() != 3 or z_t.dim() != 3 or target_t.dim() != 3:
        raise ValueError("feat_t, z_t and target_t must be 3-D")
    b, c, p = feat_t.shape
    m = z_t.shape[2]
    k = target_t.shape[1]
    expect = {"z_t": (z_t, (b, c, m)), "w1": (w1, (c, c)), "b1": (b1, (c,)),
              "w2": (w2, (c, k)), "b2": (b2, (k,)), "target_t": (target_t, (b, k, p))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for name, g in zip(("g1", "g2"), args[7:]):
        if tuple(g.shape) != (b,):
            raise ValueError(f"{name} has shape {tuple(g.shape)}, expected ({b},)")
    if not supported(c, m, k, b):
        raise ValueError(f"C={c}, M={m}, K={k}, B={b}: the kernel takes C={CHANNELS}, "
                         f"2 <= M <= {MAX_MEMBERS}, K <= {MAX_CLASSES}, B <= {MAX_BATCH}")
    return b, c, p, m, k


def _partial_rows(lib, forward: bool, which: int, b: int, m: int, k: int, p: int) -> int:
    """Rows of partial sums per batch element that kernel ``which`` writes."""
    rows = ctypes.c_int(0)
    _build.check(lib.fcomb_crps_partials(int(forward), which, b, m, k, p,
                                         ctypes.addressof(rows)), "fcomb_crps_partials")
    return rows.value


def _launch(args, kernel: str):
    """Kernel A (``kernel``: a value of FWD_KERNELS) and its partial sums."""
    b, _, p, m, k = _check(args, "fcomb_crps_terms")
    dev = args[0].device
    lib = _build.library()
    which = _KERNEL_IDS[kernel]
    with torch.cuda.device(dev):
        rows = _partial_rows(lib, True, which, b, m, k, p)
        partial = torch.empty((2, b, rows), dtype=torch.float32, device=dev)
        t1 = torch.empty(b, dtype=torch.float32, device=dev)
        t2 = torch.empty(b, dtype=torch.float32, device=dev)
        err = lib.fcomb_crps_terms_fwd(
            *(a.data_ptr() for a in args), partial.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), b, m, k, p, which, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fcomb_crps_terms_fwd")
    fcomb_crps_terms.launches += 1
    return t1, t2


def _launch_bwd(args, kernel: str, need_dy: bool):
    """Kernel A′ (``kernel``: a value of BWD_KERNELS) and its partial sums."""
    b, c, p, m, k = _check(args, "fcomb_crps_terms_bwd")
    dev = args[0].device
    lib = _build.library()
    which = _KERNEL_IDS[kernel]
    nw = c * c + c + c * k + k
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rows = _partial_rows(lib, False, which, b, m, k, p)
        dfeat = torch.empty((b, c, p), **f32)
        dy = torch.empty((b, k, p), **f32) if need_dy else None
        dz = torch.empty((b, c, m), **f32)
        dw = torch.empty(nw, **f32)
        dz_part = torch.empty((rows, b, c, m), **f32)
        w_part = torch.empty((b * rows, nw), **f32)
        err = lib.fcomb_crps_terms_bwd(
            *(a.data_ptr() for a in args), dfeat.data_ptr(),
            dy.data_ptr() if need_dy else None, dz_part.data_ptr(), w_part.data_ptr(),
            dz.data_ptr(), dw.data_ptr(), b, m, k, p, which,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fcomb_crps_terms_bwd")
    fcomb_crps_terms_bwd.launches += 1
    dw1, db1, dw2, db2 = dw.split([c * c, c, c * k, k])
    return dfeat, dz, dw1.view(c, c), db1, dw2.view(c, k), db2, dy


def fused_fcomb_crps_loss(feature_map, zs, params, target,
                          loss_type: str = "afcrps", alpha: float = 0.95,
                          compute_dtype: str = "bfloat16", rows=None) -> torch.Tensor:
    """afCRPS/CRPS of the M-member fcomb decode, fused end to end.

    feature_map (B, H, W, C) U-Net features; zs (M, B, D) latent draws;
    params: the port Fcomb's ``layer{0,1,2}_{weight,bias}`` with (cin, cout)
    weights; target (B, H, W, K). Same value as
    ``afcrps_loss(fcomb.ensemble(feats, zs), target)`` (or ``crps_loss``).
    ``rows`` (``parallel.spatial.Rows``): the inputs are this rank's block
    of rows; kernel A's per-item terms of the block are summed over the
    ranks (differentiably: A′ gets the global terms' gradient) and divided
    by the global pixel count, the JAX package's ``psum`` over "spatial".
    """
    b, h, w, c = feature_map.shape
    p = h * w
    k = target.shape[-1]
    m = zs.shape[0]
    if m < 2:
        raise ValueError(f"M must be >= 2 for {loss_type}, got {m}")
    cdt = _DTYPES[compute_dtype]
    w0 = params["layer0_weight"]                               # (C + D, C)
    # (C, C) @ (B, C, P): the features' channels-first projection
    feat_t = torch.matmul(round_to(w0[:c].T, cdt),
                          round_to(feature_map.reshape(b, p, c), cdt).transpose(1, 2))
    z_part = matmul_f32(zs, w0[c:], cdt) + params["layer0_bias"]  # (M, B, C)
    z_t = z_part.permute(1, 2, 0).contiguous()                  # (B, C, M)
    target_t = target.reshape(b, p, k).float().transpose(1, 2).contiguous()
    t1, t2 = fcomb_crps_terms(
        feat_t.contiguous(), z_t, params["layer1_weight"], params["layer1_bias"],
        params["layer2_weight"], params["layer2_bias"], target_t, compute_dtype)
    if rows is not None:
        t1, t2 = rows.sum(torch.stack([t1, t2]))
        p = rows.whole(h) * w
    if loss_type == "afcrps":
        return afcrps_from_terms(t1, t2, m, p * k, alpha)
    return crps_from_terms(t1, t2, m, p * k)
