"""SSIM / MS-SSIM over NHWC tensors (port of ``probunet_tpu/ops/msssim.py``).

The subset of ``pytorch_msssim`` the reference's WMSE-MS-SSIM loss calls
(``ms_ssim(pred, target, data_range=..., size_average=True, win_size=7)``),
with the JAX module's semantics and dtypes:

- separable Gaussian window (``win_sigma`` 1.5) built in x's dtype, VALID
  depthwise filtering, each operand filtered in its own dtype (the window
  cast to it);
- K = (0.01, 0.03), biased covariance estimates;
- 2x2 average pooling between levels with zero padding on odd sides,
  ``count_include_pad``;
- the 5-level power weights in x's dtype, ``relu`` on the cs values and
  the last ssim before their weighted product.

The depthwise filter is ``F.conv2d`` with ``groups=C`` on the NCHW view:
the JAX package computes it with XLA's grouped convolution, outside any
TPU kernel. Under the bf16 compute dtype the ELBO's members reach it in
f32 in both packages (the U-Net casts its output back to the input's
dtype), so the window and the maps are f32 there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DEFAULT_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
LEVELS = len(_DEFAULT_WEIGHTS)   # the ELBO's scales


def _gaussian_window(win_size: int, sigma: float, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    coords = torch.arange(win_size, dtype=dtype, device=device) - win_size // 2
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _gaussian_filter(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """VALID depthwise filtering of (N, H, W, C) along H, then W."""
    c, k = x.shape[-1], win.shape[0]
    w = win.to(x.dtype)
    h = x.permute(0, 3, 1, 2)
    h = F.conv2d(h, w.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    h = F.conv2d(h, w.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return h.permute(0, 2, 3, 1)


def _avg_pool2_padded(x: torch.Tensor) -> torch.Tensor:
    """2x2 / stride-2 average pool of (N, H, W, C), zero-padding odd sides,
    count_include_pad, at the JAX package's rounding points: its
    ``lax.reduce_window`` adds a window's four terms one by one in x's type
    from zero, row by row, or column by column where W is odd (XLA's order
    on the CPU, measured at f32 and bf16), then divides by 4.
    ``F.avg_pool2d`` adds row by row in f32 whatever W, so it differs at odd
    W and in bf16."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = h % 2, w % 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    oh, ow = (h + 2 * ph) // 2, (w + 2 * pw) // 2
    taps = ((0, 0), (1, 0), (0, 1), (1, 1)) if pw else ((0, 0), (0, 1), (1, 0), (1, 1))
    total = torch.zeros((x.shape[0], oh, ow, x.shape[3]), dtype=x.dtype, device=x.device)
    for i, j in taps:
        total = total + xp[:, i:i + 2 * oh:2, j:j + 2 * ow:2]
    return total / 4.0


def _ssim_maps(x, y, data_range, win, k1: float = 0.01, k2: float = 0.03):
    """(ssim map, cs map) of the VALID window positions, each (N, H - k +
    1, W - k + 1, C). A tensor ``data_range`` takes part in type promotion
    as a JAX array does (a bf16 map plus an f32 constant is f32), hence its
    (1,) shape."""
    if torch.is_tensor(data_range):
        data_range = data_range.reshape(1)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _gaussian_filter(x, win)
    mu2 = _gaussian_filter(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _gaussian_filter(x * x, win) - mu1_sq
    sigma2_sq = _gaussian_filter(y * y, win) - mu2_sq
    sigma12 = _gaussian_filter(x * y, win) - mu1_mu2
    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map, cs_map


def _ssim_components(x, y, data_range, win, rows=None):
    """(ssim per channel, cs per channel), each (N, C): the maps' means.

    ``rows`` (``parallel.spatial.Rows``): x and y are this rank's block of
    image rows. Both are padded by one halo exchange of ``k // 2`` rows
    (stacked on the channels; the products x², y² and xy are pointwise, so
    formed on the padded block they are the products' halos), filtered
    VALID, which leaves one map row per block row, and the rows whose
    window reaches past the image's top or bottom (outside the unsharded
    VALID maps) are left out of the sums, which are summed over the ranks
    and divided by the global count."""
    if rows is None:
        ssim_map, cs_map = _ssim_maps(x, y, data_range, win)
        return ssim_map.mean(dim=(1, 2)), cs_map.mean(dim=(1, 2))
    c, half = x.shape[-1], win.shape[0] // 2
    h, height = x.shape[1], rows.whole(x.shape[1])
    x, y = rows.halo(torch.cat([x, y], dim=-1), half).split(c, dim=-1)
    ssim_map, cs_map = _ssim_maps(x, y, data_range, win)
    r0 = rows.first(h)
    lo, hi = min(max(half - r0, 0), h), min(max(height - half - r0, 0), h)
    sums = torch.stack([ssim_map[:, lo:hi].sum(dim=(1, 2)), cs_map[:, lo:hi].sum(dim=(1, 2))])
    s, cs = rows.sum(sums) / ((height - 2 * half) * ssim_map.shape[2])
    return s, cs


def ssim(x: torch.Tensor, y: torch.Tensor, data_range, win_size: int = 11,
         win_sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """Single-scale SSIM of (N, H, W, C) tensors."""
    win = _gaussian_window(win_size, win_sigma, x.dtype, x.device)
    s, _ = _ssim_components(x, y, data_range, win)
    s = torch.relu(s)
    return s.mean() if size_average else s.mean(dim=1)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range, win_size: int = 11,
            win_sigma: float = 1.5, weights=_DEFAULT_WEIGHTS,
            size_average: bool = True, rows=None) -> torch.Tensor:
    """Multi-scale SSIM of (N, H, W, C) tensors. The shorter side must
    exceed (win_size - 1) * 2**(levels - 1): 96 at win_size 7 and five
    levels, so the ELBO's MS-SSIM runs at 128x128.

    ``rows`` (``parallel.spatial.Rows``): x and y are this rank's block of
    image rows (:func:`_ssim_components`); the result is the whole
    image's, alike on every rank. The 2x2 pools between scales stay on the
    block, so its rows must divide by 2**(levels - 1)."""
    height = x.shape[1] if rows is None else rows.whole(x.shape[1])
    smaller = min(height, x.shape[2])
    if not smaller > (win_size - 1) * 2 ** (len(weights) - 1):
        raise ValueError(f"image side {smaller} too small for {len(weights)}-level MS-SSIM "
                         f"with win_size={win_size}")
    levels = len(weights)
    if rows is not None and x.shape[1] % 2 ** (levels - 1):
        raise ValueError(f"a block of {x.shape[1]} rows does not divide by 2^{levels - 1} "
                         f"(MS-SSIM's pools between its {levels} scales)")
    win = _gaussian_window(win_size, win_sigma, x.dtype, x.device)
    w = torch.tensor(weights, dtype=x.dtype, device=x.device)
    vals = []  # cs of each level, then ssim of the last; each (N, C)
    for i in range(levels):
        s, cs = _ssim_components(x, y, data_range, win, rows)
        if i < levels - 1:
            vals.append(torch.relu(cs))
            x, y = _avg_pool2_padded(x), _avg_pool2_padded(y)
    vals.append(torch.relu(s))
    msv = torch.prod(torch.stack(vals) ** w.reshape(-1, 1, 1), dim=0)  # (N, C)
    return msv.mean() if size_average else msv.mean(dim=1)
