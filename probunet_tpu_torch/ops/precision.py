"""Rounding points shared by the models and the kernels' plain versions.

The JAX package computes its products with operands cast to the compute
dtype and f32 accumulation (``preferred_element_type=jnp.float32``).
PyTorch's bf16 matmul returns a bf16-rounded result instead, so the port
rounds the operands to the compute dtype and multiplies them in f32: the
same operand rounding, an f32 result.
"""

from __future__ import annotations

import torch


def round_to(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and returned as f32 (``None``: f32)."""
    if dtype is None or dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype | None) -> torch.Tensor:
    """a @ b with operands rounded to ``dtype``, f32 result."""
    return torch.matmul(round_to(a, dtype), round_to(b, dtype))
