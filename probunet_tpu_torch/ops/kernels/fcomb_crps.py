"""Fused Fcomb decode + CRPS terms: CUDA kernel (``csrc/fcomb_crps.cu``)
and plain version.

Port of ``probunet_tpu/ops/pallas/fcomb_crps.py`` (forward only). The
afCRPS ELBO's reconstruction term is CRPS(fcomb-decoded ensemble,
target); :func:`fcomb_crps_terms` computes its two per-batch sums straight
from the layer-0 projections, per member m and pixel p:

    h0 = relu(feat[:, p] + z[:, m]);  h1 = relu(W1^T h0 + b1);
    x  = W2^T h1 + b2

without storing the (B, M, H, W, K) ensemble or the hiddens. The layer-0
split projections (``feats @ W0f`` and ``zs @ W0z + b0``) stay
``torch.matmul`` outside the kernel, as the JAX package leaves them to
XLA. The analytic backward (the TPU's ``bwd_impl``) is not ported yet: a
CUDA call on tensors that require grad raises.
"""

from __future__ import annotations

import torch

from probunet_tpu_torch.ops.kernels import _build
from probunet_tpu_torch.ops.kernels.afcrps import ensemble_crps_terms_plain
from probunet_tpu_torch.ops.losses import afcrps_from_terms, crps_from_terms
from probunet_tpu_torch.ops.precision import matmul_f32, round_to

SOURCE = "probunet_tpu_torch/csrc/fcomb_crps.cu"
REPLACES = "probunet_tpu/ops/pallas/fcomb_crps.py:264"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def fcomb_crps_terms(feat_t, z_t, w1, b1, w2, b2, target_t,
                     compute_dtype: str = "bfloat16"):
    """(t1, t2) per batch element over the fcomb-decoded ensemble.

    feat_t (B, C, P) f32 — feats @ W0f, channels first (P = H*W);
    z_t (B, C, M) f32 — (zs @ W0z + b0) transposed;
    w1/b1 (C, C)/(C,), w2/b2 (C, K)/(K,) — fcomb layers 1-2;
    target_t (B, K, P) f32. Operands are rounded to ``compute_dtype``
    ("bfloat16" or "float32") with f32 accumulation.

    CPU tensors take :func:`fcomb_crps_terms_plain`; CUDA tensors launch
    the kernel (C = 32, 2 <= M <= 32, K <= 4) or raise.
    """
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(_DTYPES)}")
    args = (feat_t, z_t, w1, b1, w2, b2, target_t)
    if all(a.device.type == "cpu" for a in args):
        return fcomb_crps_terms_plain(*args, compute_dtype)
    return _launch(args, compute_dtype == "bfloat16")


fcomb_crps_terms.launches = 0


def _launch(args, bf16_operands: bool):
    feat_t, z_t, w1, b1, w2, b2, target_t = args
    dev = feat_t.device
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("fcomb_crps_terms: the kernel needs every operand on "
                         f"one CUDA device; got {[str(a.device) for a in args]}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            "fcomb_crps_terms has no CUDA backward yet; call it under "
            "torch.no_grad() or with tensors that do not require grad")
    if any(a.dtype != torch.float32 for a in args):
        raise ValueError("fcomb_crps_terms: the kernel takes f32 operands; got "
                         f"{[a.dtype for a in args]}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("fcomb_crps_terms: operands must be contiguous")
    lib = _build.library()
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
    if c != lib.fcomb_crps_channels():
        raise ValueError(f"C={c}: the kernel is built for C={lib.fcomb_crps_channels()}")
    if not 2 <= m <= lib.fcomb_crps_max_members():
        raise ValueError(f"M={m} outside the kernel's 2..{lib.fcomb_crps_max_members()}")
    if not 1 <= k <= lib.fcomb_crps_max_classes():
        raise ValueError(f"K={k} outside the kernel's 1..{lib.fcomb_crps_max_classes()}")
    if not 1 <= b <= 65535:
        raise ValueError(f"B={b} outside the kernel's 1..65535")
    ntiles = -(-p // lib.fcomb_crps_tile_pixels())
    with torch.cuda.device(dev):
        partial = torch.empty((2, b, ntiles), dtype=torch.float32, device=dev)
        t1 = torch.empty(b, dtype=torch.float32, device=dev)
        t2 = torch.empty(b, dtype=torch.float32, device=dev)
        err = lib.fcomb_crps_terms_fwd(
            *(a.data_ptr() for a in args), partial.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), b, m, k, p, int(bf16_operands),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fcomb_crps_terms_fwd")
    fcomb_crps_terms.launches += 1
    return t1, t2


def fused_fcomb_crps_loss(feature_map, zs, params, target,
                          loss_type: str = "afcrps", alpha: float = 0.95,
                          compute_dtype: str = "bfloat16") -> torch.Tensor:
    """afCRPS/CRPS of the M-member fcomb decode, fused end to end.

    feature_map (B, H, W, C) U-Net features; zs (M, B, D) latent draws;
    params: the port Fcomb's ``layer{0,1,2}_{weight,bias}`` with (cin, cout)
    weights; target (B, H, W, K). Same value as
    ``afcrps_loss(fcomb.ensemble(feats, zs), target)`` (or ``crps_loss``).
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
    if loss_type == "afcrps":
        return afcrps_from_terms(t1, t2, m, p * k, alpha)
    return crps_from_terms(t1, t2, m, p * k)
