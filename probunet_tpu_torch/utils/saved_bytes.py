"""The bytes a training step keeps for its backward pass, with and without
int8 saved convolution inputs (``ops.act_compress``).

:func:`saved_bytes` counts what autograd keeps while a function runs
(``torch.autograd.graph.saved_tensors_hooks``): each saved tensor's
storage once, so a tensor two operations save (the skip convolution's
input is the input GroupNorm kernel C saves too) counts once, and the
parameters' storages not at all (they are resident anyway). On the CPU
the kernels' plain versions run, which save what the kernels save.
"""

from __future__ import annotations

import torch

from probunet_tpu_torch.data.climex import preprocess_batch
from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet


def saved_bytes(fn, params=()) -> dict:
    """Run ``fn()`` and count what autograd saves for the backward:
    {"bytes", "tensors", "by_dtype"} over distinct storages, the storages
    of ``params`` left out."""
    skip = {p.untyped_storage().data_ptr() for p in params}
    seen: dict[int, tuple[int, str]] = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = (st.nbytes(), str(t.dtype).removeprefix("torch."))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    by_dtype: dict[str, int] = {}
    for n, dt in seen.values():
        by_dtype[dt] = by_dtype.get(dt, 0) + n
    del out
    return {"bytes": sum(by_dtype.values()), "tensors": len(seen), "by_dtype": by_dtype}


def elbo_saved_bytes(model: ProbabilisticUNet, cfg, hr: torch.Tensor, stats) -> dict:
    """:func:`saved_bytes` of the training ELBO (M = ``ensemble_size``,
    dropout on) of the raw HR batch ``hr``, as ``train.loop`` runs it."""
    d = cfg.data
    batch = preprocess_batch(hr, stats, d.pipeline, d.lowres_scale, d.interp_mode, d.epsilon,
                             d.standardization)
    gen = torch.Generator(device=hr.device).manual_seed(0)
    return saved_bytes(lambda: model.elbo(
        batch["inputs"], batch["targets"], M=cfg.train.ensemble_size, beta_1=1.0,
        generator=gen, training=True)[0], list(model.parameters()))
