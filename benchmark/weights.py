"""Seeded weights, made on the device in a few large calls and handed to
the program and to the reference alike.

The leaves are laid out in the order of their sorted names, so the layout
does not depend on either side's module order. One standard normal draw
fills them all; each leaf then gets its scale and offset: GroupNorm
scales 1 + 0.1 n, other vectors 0.1 n, matrices and kernels n / sqrt(fan
in), times sqrt(2) in the ReLU stacks (the Gaussians and the combination
head, whose matrices are stored (in, out)). The Gaussians' heads (mu and
log sigma) start small: weights 0.1 n / sqrt(fan in), biases 0, so every
sigma starts near 1. With heads at the scale of the rest, log sigma
starts at several units, the KL at 1e5 to 1e6, and the training step
diverges to an infinite KL within a few tens of steps in float32 as in
bfloat16.
"""

from __future__ import annotations

import math

import torch

RELU_STACKS = ("prior.", "posterior.", "fcomb.")
HEADS = (".conv_mu.", ".conv_log_sigma.")
HEAD_GAIN = 0.1


def mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed of (run seed, stream)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (2 ** 63)


def _scale_offset(name: str, shape) -> tuple[float, float]:
    if any(h in name for h in HEADS):
        return (0.0, 0.0) if len(shape) == 1 else (HEAD_GAIN / math.sqrt(math.prod(shape[1:])),
                                                   0.0)
    if len(shape) == 1:
        is_norm_scale = name.endswith(".weight") and ("norm" in name.rsplit(".", 2)[-2])
        return 0.1, (1.0 if is_norm_scale else 0.0)
    fan_in = shape[0] if name.startswith("fcomb.") else math.prod(shape[1:])
    gain = math.sqrt(2.0) if name.startswith(RELU_STACKS) else 1.0
    return gain / math.sqrt(fan_in), 0.0


def seeded(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor} for ``spec`` [(name, shape), ...] from ``seed``."""
    leaves = sorted((n, tuple(s)) for n, s in spec)
    sizes = [math.prod(s) for _, s in leaves]
    so = torch.tensor([_scale_offset(n, s) for n, s in leaves], dtype=torch.float32,
                      device=device)
    reps = torch.tensor(sizes, device=device)
    g = torch.Generator(device=device).manual_seed(mix(seed, 1))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat = flat * so[:, 0].repeat_interleave(reps) + so[:, 1].repeat_interleave(reps)
    return {n: t.view(s) for (n, s), t in zip(leaves, flat.split(sizes))}
