"""The benchmark's frozen yardstick: FLOPs of a step counted over the plain
reference on meta tensors, the bytes and operations each hand-written
kernel's work needs at its shapes, the card's published peaks and the
kernel-name families the per-layer metrics read. None of it reads the
measured program, so a change to the program cannot move it.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.model import ProbUNet

HERE = Path(__file__).resolve().parent
PEAKS = json.loads((HERE / "peaks.json").read_text())
FAMILIES = json.loads((HERE / "families.json").read_text())["families"]
ELEMENTWISE = "other"
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def family(kernel_name: str) -> str:
    """The family of a kernel name, or ``"other"`` (elementwise work)."""
    for fam, keys in FAMILIES:
        if any(k in kernel_name for k in keys):
            return fam
    return ELEMENTWISE


class _Counting(ProbUNet):
    """The reference that also records each GroupNorm chain it runs:
    (B, C, H, W) and whether it drops out."""

    def __init__(self, sizes):
        super().__init__(sizes)
        self.chains: list[tuple[tuple[int, int, int, int], bool]] = []

    def _gn(self, P, name, x, silu, film=None, p=0.0, seed=None, b0=0, b_total=None):
        if name.startswith("unet."):
            self.chains.append((tuple(x.shape), p > 0.0))
        return ProbUNet._gn(P, name, x, silu, film, p, seed, b0, b_total)


def _meta_inputs(net: ProbUNet, batch: int, members: int, grad: bool):
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev, requires_grad=grad) for n, s in net.spec}
    h, w = net.res
    x = torch.empty((batch, h, w, net.cin), device=dev)
    tgt = torch.empty((batch, h, w, net.k), device=dev)
    eps = torch.empty((members, batch, net.d), device=dev)
    seeds = torch.zeros((len(net.dropout_blocks), 2), dtype=torch.int32, device=dev)
    return P, x, tgt, eps, seeds


def train_step(sizes: dict, members: int, batch: int = 1):
    """(FLOPs, chains) of one training step (ELBO forward and backward) at
    ``batch``, counted on meta tensors."""
    net = _Counting(sizes)
    P, x, tgt, eps, seeds = _meta_inputs(net, batch, members, True)
    with FlopCounterMode(display=False) as counter:
        total, *_ = net.elbo_items(P, x, tgt, eps, seeds, 0.95, 1.0, 1e-3)
        torch.autograd.grad(total.sum(), list(P.values()), allow_unused=True)
    return int(counter.get_total_flops()), net.chains


def sample(sizes: dict, members: int, batch: int = 1):
    """(FLOPs, chains) of one prior ensemble of ``members`` at ``batch``."""
    net = _Counting(sizes)
    P, x, _, eps, _ = _meta_inputs(net, batch, members, False)
    with FlopCounterMode(display=False) as counter:
        net.sample(P, x, eps)
    return int(counter.get_total_flops()), net.chains


def _least_s(n_bytes: float, n_ops: float, dtype: str) -> float:
    """The least time: bytes at the HBM rate or operations at the peak of
    ``dtype``, whichever is longer."""
    return max(n_bytes / PEAKS["hbm_bytes_per_s"], n_ops / PEAKS["flops_per_s"][dtype])


def gn_bound_s(shape, dropout: bool, dtype: str, backward: bool) -> float:
    """Kernel C's (or C′'s) least time on a chain of NCHW ``shape``: x read
    and y written (C′: x and g read, dx written) once in ``dtype``, the
    (C,) and (B, C) vectors and (B, G) statistics once in f32; ~10 (C′
    ~30) f32 operations an element, ~16 more for the mask."""
    b, c, h, w = shape
    n = b * c * h * w
    g = min(32, c // 4)
    vec = 4.0 * (2 * c + 2 * b * c + 2 * b * g)
    hash_ops = 16.0 if dropout else 0.0
    if backward:
        return _least_s(3.0 * ITEMSIZE[dtype] * n + vec + 8.0 * b * c, (30.0 + hash_ops) * n,
                        "float32")
    return _least_s(2.0 * ITEMSIZE[dtype] * n + vec, (10.0 + hash_ops) * n, "float32")


def fcomb_crps_bound_s(b: int, p: int, m: int, c: int, k: int, dtype: str,
                       backward: bool) -> float:
    """Kernel A's (or A′'s) least time: the f32 layer-0 projections and the
    target read (A′: and their gradients written) once; the decode's
    products 2 B P M (C^2 + C K), A′ three times as many."""
    if backward:
        return _least_s(8.0 * b * p * (c + k), 2.0 * b * p * m * (3 * c * c + 3 * c * k), dtype)
    return _least_s(4.0 * b * p * (c + k), 2.0 * b * p * m * (c * c + c * k), dtype)
