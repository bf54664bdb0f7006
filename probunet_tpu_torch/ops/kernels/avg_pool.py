"""Kernel G: the non-overlapping k x k window mean of a channels-last field,
in XLA's order of additions. CUDA kernel (``csrc/resample.cu``), its
launch plan and the plain version.

No TPU kernel: the JAX package's ``probunet_tpu/ops/resample.py:avg_pool``
is a reshape-mean that XLA lowers to one reduction. XLA on the CPU adds
each window's k*k terms one by one in row-major order (row i, then column
j), starting from zero, and multiplies the sum by f32(1 / k^2); it does not
divide. ``Tensor.mean`` over the window axes adds in another order, so its
last bit differs from JAX's on most outputs of a field that spans six decades, and
the per-pixel statistics of the ingest inherit it. Both versions here add
in XLA's order, so the pooled field is the JAX package's bit for bit.

- :func:`window_mean_plain`: k*k additions of strided views of x, then the
  product; used for CPU tensors (the tests, host ingest on the CPU).
- :func:`plan`: how G runs a shape, made before the launch and cached.
  The order fixes only the sequence of one output's additions, so the
  window rows stream and the outputs' chains interleave. Route
  ``"ring"`` (C < 32, x and its window rows on 16 bytes): a block walks
  tiles of output rows and columns, a thread a chain, and the tiles'
  window rows pass through a ring of shared-memory slots filled by
  16-byte cp.async while the previous row adds; columns sit at a padded
  stride so a warp's reads do not conflict. Route ``"direct"`` ((k, C) =
  (8, 1), the 64x64 presets, x on 16 bytes): a thread an output column,
  each window row read as two float4s with the next one in flight.
  Route ``"channels"`` (everything else: C >= 32, where a warp's
  channels coalesce without staging, x or its rows off 16 bytes, or a
  window row the ring cannot hold): a thread an output, straight from
  device memory; it takes every shape. k = 16 and 8 are template
  instances whose loads run ahead of the adds; any other k takes the
  generic instance.
- :func:`window_mean`: the wrapper. A CUDA tensor launches kernel G (f32,
  row-major (..., H, W, C)), one launch a pooling, or raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from probunet_tpu_torch.ops.kernels import _build

SOURCE = "probunet_tpu_torch/csrc/resample.cu"
REPLACES = "probunet_tpu/ops/resample.py:31"   # x.mean(axis=(-4, -2))

# The H100's limits the plan keeps to (the kernels' launch bound is 256
# threads), and its choices
SMS = 132                  # H100 SXM; :func:`plan` takes the card's count
SMEM_BLOCK = 232_448       # shared memory a block can take (227 KB)
SMEM_SM = 233_472          # an SM's shared memory for blocks (228 KB)
SMEM_RESERVED = 1024       # the runtime's share a block
BLOCKS_SM = 32
THREADS_SM = 2048
THREADS_MAX = 256
STAGES = 3                 # ring slots: window rows i+1 and i+2 land while row i adds
BLOCK_CHAINS = 32          # "ring": a tile's chains, rounded up to whole output rows
CHANNELS_MIN = 32          # from here a warp's channels make 128-byte loads
INSTANCES = (16, 8)        # k with a template instance of their own
DIRECT = (8, 1)            # (k, C) of the "direct" instance
DIRECT_THREADS = 64
CHANNELS_THREADS = 256
ROUTES = {"ring": 0, "direct": 1, "channels": 2}


class Plan(NamedTuple):
    """How kernel G runs one shape (:func:`plan`)."""

    route: str          # "ring", "direct" or "channels"
    k_inst: int         # the instance's k: 16, 8, or 0 for any k
    rows: int           # "ring": output rows of a tile
    cols: int           # "ring": output columns of a tile
    col_stride: int     # "ring": floats between two columns' window rows in a slot
    row_stride: int     # "ring": floats between two output rows' window rows in a slot
    stages: int         # "ring": slots of the ring
    threads: int        # a block's
    smem: int           # dynamic shared memory of a block, bytes
    grid: int           # blocks (the "ring" blocks walk tiles, the others outputs)


def inverse_area(k: int) -> np.float32:
    """f32(1 / k^2), the factor XLA multiplies each window's sum by."""
    return np.float32(1.0 / (k * k))


def _check_shape(x: torch.Tensor, k: int) -> None:
    if x.dim() < 3:
        raise ValueError(f"window_mean: x must be (..., H, W, C), got shape {tuple(x.shape)}")
    h, w = x.shape[-3:-1]
    if k < 1 or h % k or w % k:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {k}")


def _conflicts(rows: int, cols: int, c: int, cs: int, rs: int, chains: int) -> int:
    """The most distinct words any one bank serves in a warp's read of the
    slot (every thread's chain at the same window column)."""
    worst = 1
    for w0 in range(0, chains, 32):
        banks: dict[int, set] = {}
        for t in range(w0, min(w0 + 32, chains)):
            r, o = divmod(t, cols * c)
            b, ch = divmod(o, c)
            addr = r * rs + b * cs + ch
            banks.setdefault(addr % 32, set()).add(addr)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


def _strides(k: int, c: int, rows: int, cols: int) -> tuple[int, int]:
    """(col_stride, row_stride) of a slot: the least padding (whole 16-byte
    copies) whose reads conflict least."""
    chains = rows * cols * c
    best = None
    for pc in range(0, 32, 4):
        cs = k * c + pc
        for pr in range(0, 32 if rows > 1 else 1, 4):
            rs = cols * cs + pr
            key = (_conflicts(rows, cols, c, cs, rs, chains), rows * rs, cs)
            if best is None or key < best[0]:
                best = (key, cs, rs)
    return best[1], best[2]


def _ring(items: int, ho: int, wo: int, c: int, k: int, sms: int) -> Plan | None:
    """The "ring" plan, or None where two slots of one column's window row
    do not fit a block's shared memory."""
    rows_out = items * ho
    kc = k * c
    cols = next((d for d in range(min(wo, THREADS_MAX // c), 0, -1)
                 if wo % d == 0 and 2 * d * kc * 4 <= SMEM_BLOCK), None)
    if cols is None:
        return None
    rows = 1
    if cols == wo:
        most = min(THREADS_MAX, max(BLOCK_CHAINS, wo * c)) // (wo * c)
        rows = next(d for d in range(most, 0, -1) if rows_out % d == 0)
    cs, rs = _strides(k, c, rows, cols)
    slot = rows * rs * 4
    stages = min(STAGES, SMEM_BLOCK // slot)
    if stages < 2:
        return None
    threads = -(-rows * cols * c // 32) * 32
    smem = stages * slot
    per_sm = min(BLOCKS_SM, THREADS_SM // threads, SMEM_SM // (smem + SMEM_RESERVED))
    tiles = rows_out // rows * (wo // cols)
    return Plan("ring", k if k in INSTANCES else 0, rows, cols, cs, rs, stages, threads, smem,
                min(tiles, sms * per_sm))


@functools.lru_cache(maxsize=None)
def plan(items: int, h: int, w: int, c: int, k: int, aligned: bool = True,
         sms: int = SMS) -> Plan:
    """Kernel G's plan for ``items`` fields (h, w, c) pooled by k; ``aligned``:
    x starts on 16 bytes; ``sms``: the card's SMs. Rule: where x and its
    window rows lie on 16 bytes, "direct" for (k, C) = (8, 1) and "ring"
    for C < 32 where two slots of one column's window row fit a block's
    shared memory; else "channels". A shape G does not take raises
    ValueError. Cached: immutable.

    The rule follows the card's readings of every route (H100 80GB HBM3,
    700 W; PERF.md, kernel G): at the flagship's (128, 128, 128, 3) by 16
    the ring took 0.0106 ms, "channels" 0.0114 and ``Tensor.mean``
    0.0160; at the 64x64 presets' (128, 64, 64, 1) by 8 the ring's eight
    window rows of 32 bytes a column wait one after another (0.0057 ms)
    and "direct" reads them from device memory in 0.0029; the ring's
    4-byte copies for an x off 16 bytes (0.0175 ms at the flagship's
    batch) lost to "channels" (0.0115), which reads scalars anyway."""
    if items < 1 or c < 1 or k < 1 or h < k or w < k or h % k or w % k:
        raise ValueError(f"window_mean: G takes no pooling of {(items, h, w, c)} by {k}")
    ho, wo = h // k, w // k
    vectors = aligned and (w * c) % 4 == 0 and (k * c) % 4 == 0
    if vectors and (k, c) == DIRECT:
        n = items * ho * wo
        return Plan("direct", k, 0, 0, 0, 0, 0, DIRECT_THREADS, 0,
                    min(-(-n // DIRECT_THREADS), sms * (THREADS_SM // DIRECT_THREADS)))
    if vectors and c < CHANNELS_MIN:
        p = _ring(items, ho, wo, c, k, sms)
        if p is not None:
            return p
    n = items * ho * wo * c
    return Plan("channels", k if k in INSTANCES else 0, 0, 0, 0, 0, 0, CHANNELS_THREADS, 0,
                min(-(-n // CHANNELS_THREADS), sms * (THREADS_SM // CHANNELS_THREADS)))


def window_mean_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k window means of x (..., H, W, C): each window's terms
    added in row-major order from zero (in f32, or f64 for f64 x), the sum
    times f32(1 / k^2), cast to x's type."""
    _check_shape(x, k)
    *lead, h, w, c = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    v = x.reshape(*lead, h // k, k, w // k, k, c)
    acc = torch.zeros((*lead, h // k, w // k, c), dtype=acc_dtype, device=x.device)
    for i in range(k):
        for j in range(k):
            acc += v[..., i, :, j, :]
    acc *= torch.tensor(float(inverse_area(k)), dtype=acc_dtype, device=x.device)
    return acc.to(x.dtype)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_of(x: torch.Tensor, k: int) -> Plan:
    """:func:`plan` for a CUDA tensor x (..., H, W, C)."""
    *lead, h, w, c = x.shape
    return plan(math.prod(lead), h, w, c, k, x.data_ptr() % 16 == 0, _sms(x.device))


def _launch(x: torch.Tensor, k: int) -> torch.Tensor:
    _check_shape(x, k)
    if x.dtype != torch.float32:
        raise ValueError(f"window_mean: kernel G takes f32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"window_mean: x (shape {tuple(x.shape)}, strides {x.stride()}) "
                         "is not row-major contiguous")
    *lead, h, w, c = x.shape
    out = torch.empty((*lead, h // k, w // k, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    pl = plan_of(x, k)
    with torch.cuda.device(x.device):
        err = _build.library().window_mean_f32(
            x.data_ptr(), out.data_ptr(), math.prod(lead), h, w, c, k, float(inverse_area(k)),
            ROUTES[pl.route], pl.k_inst, pl.rows, pl.cols, pl.col_stride, pl.row_stride,
            pl.stages, pl.threads, pl.smem, pl.grid,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "window_mean_f32")
    window_mean.launches += 1
    return out


def window_mean(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k window means of x (..., H, W, C) in XLA's order of
    additions: :func:`window_mean_plain` for a CPU tensor, kernel G for a
    CUDA tensor (f32, contiguous, on :func:`plan`'s route; anything else
    raises)."""
    if x.device.type == "cpu":
        return window_mean_plain(x, k)
    return _launch(x, k)


window_mean.launches = 0
