"""int8 post-training quantization for the serving path (port of
``probunet_tpu/ops/quantize.py``).

Scheme, as in the JAX package: weights quantized per output channel
(symmetric, ``s_w = absmax / 127``), activations per tensor with STATIC
scales measured by a calibration pass (``in_scale = absmax / 127``), the
convolution int8 x int8 -> int32 and rescaled to f32 (kernel E,
``ops.kernels.int8_conv``).

A scales tree is a nested dict keyed by the JAX package's module paths
(``{"prior": {"conv_mu": {"in_scale": s}}, "unet": {...}}``), its leaves 0-d
f32 tensors named ``in_scale`` (and ``in_scale2`` for a split convolution's
second input). The port's module names follow the Flax names, so a tree
converts one to one (``convert.convert_quant``) and a ``--quant-skip``
pattern selects the same convolutions in both packages.

In PyTorch's idiom, instead of Flax's ``quant_stats``/``quant`` collections:

    with record_absmax(model) as rec:      # calibration: the sow with reduce_fn=maximum
        model.sample(x, M, eps=eps)
    scales = quant_scales_from_stats(rec.stats())
    with attached(model, scales):           # serving: every conv that finds its scale runs int8
        out = model.sample(x, M, eps=eps)

The hooks live in ``models/layers.py`` (``EDMConv``) and
``models/gaussian.py`` (``_Conv3x3``): a convolution takes the int8 route
only when every scale its call needs is attached, else its float path (the
JAX package's pruning by :func:`quant_skip`). The int8 route has no
gradient: with grad enabled and a parameter or input requiring grad it
raises.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Iterable

import torch

from probunet_tpu_torch.ops.kernels import int8_conv as _e
from probunet_tpu_torch.ops.kernels.int8_conv import quantize_int8, weight_scales

SCALE_NAMES = {"absmax": "in_scale", "absmax2": "in_scale2"}

# --quant-skip alias: keep the latent distribution heads (the prior's and
# posterior's conv_mu and conv_log_sigma, 1x1 convolutions on the global
# average pool) in float: they move no meaningful bytes, and a log_sigma
# error exponentiates into the ensemble's spread
SKIP_ALIASES = {"heads": r"conv_mu|conv_log_sigma"}


def int8_conv(x: torch.Tensor, w: torch.Tensor, in_scale, pad: int) -> torch.Tensor:
    """Quantized NHWC convolution of ``x`` (B, H, W, cin), float, with the
    OIHW weight ``w`` (cout, cin, k, k) quantized per output channel:
    (B, H, W, cout) f32 = f32(int32 sums) * (in_scale * s_w), through
    kernel E on the card. ``pad`` must be k // 2 (SAME)."""
    if pad != w.shape[-1] // 2:
        raise ValueError(f"int8_conv: pad {pad} for a {w.shape[-1]}x{w.shape[-1]} kernel; "
                         "only SAME padding is ported")
    return _e.int8_conv(x, _e.quantize_weight(w), in_scale, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Scales trees
# ---------------------------------------------------------------------------

def tree_leaves(tree: Dict[str, Any]) -> list:
    """The leaves of a nested dict, depth first in key order."""
    out = []
    for v in tree.values():
        out += tree_leaves(v) if isinstance(v, dict) else [v]
    return out


def quant_scales_from_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
    """An absmax tree (``absmax``/``absmax2`` leaves) -> a scales tree
    (``in_scale``/``in_scale2``): max(absmax, 1e-12) / 127 in f32, so an
    all-zero calibration input gives a tiny scale, not 0/0 at serve time."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = quant_scales_from_stats(v)
        else:
            out[SCALE_NAMES[k]] = _e.over_qmax(torch.as_tensor(v, dtype=torch.float32)
                                               .clamp_min(1e-12))
    return out


def merge_stats(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Elementwise-max fold of two absmax trees of the same structure."""
    if set(a) != set(b):
        raise ValueError(f"merge_stats: trees differ: {sorted(set(a) ^ set(b))}")
    return {k: merge_stats(v, b[k]) if isinstance(v, dict) else torch.maximum(
        torch.as_tensor(v), torch.as_tensor(b[k])) for k, v in a.items()}


def quant_skip(scales: Dict[str, Any], patterns) -> Dict[str, Any]:
    """Prune the scales whose "/"-joined path (``prior/conv_mu/in_scale``)
    matches any regex of ``patterns`` (``re.search``; the alias "heads" is
    ``SKIP_ALIASES["heads"]``); empty subtrees are dropped. No patterns:
    ``scales`` itself."""
    pats = [re.compile(SKIP_ALIASES.get(p, p)) for p in (patterns or [])]
    if not pats:
        return scales

    def walk(node, path):
        out = {}
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                sub = walk(v, p)
                if sub:
                    out[k] = sub
            elif not any(r.search(p) for r in pats):
                out[k] = v
        return out

    return walk(scales, "")


# ---------------------------------------------------------------------------
# Hooks: calibration and serving
# ---------------------------------------------------------------------------

def hooked_convs(model: torch.nn.Module) -> dict[str, torch.nn.Module]:
    """The convolutions of ``model`` that carry the int8 hooks, by their
    "/"-joined module path: the modules with a ``quant_scales`` slot and a
    weight (``EDMConv`` with a kernel and ``_Conv3x3``)."""
    return {name.replace(".", "/"): mod for name, mod in model.named_modules()
            if hasattr(mod, "quant_scales") and getattr(mod, "weight", None) is not None}


_RECORDERS: list["record_absmax"] = []


class record_absmax(contextlib.AbstractContextManager):
    """Inside the context, every hooked convolution of ``model`` that runs
    records the absmax of its input (``absmax``; ``absmax2`` of a split
    convolution's second input) in f32, keeping the largest over calls and
    batches: Flax's ``sow`` with ``reduce_fn=maximum``. :meth:`stats` is the
    tree of the convolutions that ran (0-d f32 tensors on their device)."""

    def __init__(self, model: torch.nn.Module):
        self.paths = {id(mod): path for path, mod in hooked_convs(model).items()}
        if not self.paths:
            raise ValueError("record_absmax: the model has no hooked convolution")
        self._max: dict[tuple[str, str], torch.Tensor] = {}

    def __enter__(self):
        _RECORDERS.append(self)
        return self

    def __exit__(self, *exc):
        _RECORDERS.remove(self)
        return False

    def _add(self, mod: torch.nn.Module, name: str, x: torch.Tensor) -> None:
        path = self.paths.get(id(mod))
        if path is None:
            return
        v = x.detach().abs().amax().float()
        prev = self._max.get((path, name))
        self._max[(path, name)] = v if prev is None else torch.maximum(prev, v)

    def stats(self) -> Dict[str, Any]:
        tree: dict = {}
        for (path, name), v in sorted(self._max.items()):
            node = tree
            for part in path.split("/"):
                node = node.setdefault(part, {})
            node[name] = v
        return tree


def observe(mod: torch.nn.Module, x: torch.Tensor, name: str = "absmax") -> None:
    """A hooked convolution's input seen by every active :class:`record_absmax`."""
    for rec in _RECORDERS:
        rec._add(mod, name, x)


def attach(model: torch.nn.Module, scales: Dict[str, Any]) -> torch.nn.Module:
    """Attach a scales tree to ``model``'s hooked convolutions (replacing any
    attached before); a path that names no hooked convolution, or a leaf
    other than ``in_scale``/``in_scale2``, raises. The scales are kept as
    0-d f32 CPU tensors, so a launch reads them without a device sync."""
    convs = hooked_convs(model)
    found: dict[str, dict] = {}

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, p)
            elif path not in convs or k not in SCALE_NAMES.values():
                raise ValueError(f"quant scale {p!r} names no hooked convolution of the model")
            else:
                found.setdefault(path, {})[k] = torch.as_tensor(
                    v, dtype=torch.float32).detach().cpu().reshape(())

    walk(scales, "")
    detach(model)
    for path, q in found.items():
        convs[path].quant_scales = q
    return model


def detach(model: torch.nn.Module) -> torch.nn.Module:
    """Remove every attached scale: all convolutions take their float path."""
    for mod in hooked_convs(model).values():
        mod.quant_scales = None
    return model


@contextlib.contextmanager
def attached(model: torch.nn.Module, scales: Dict[str, Any] | None):
    """``scales`` attached inside the context (nothing when None), detached
    after."""
    if scales is None:
        yield model
        return
    attach(model, scales)
    try:
        yield model
    finally:
        detach(model)


def takes_int8(mod: torch.nn.Module, two: bool) -> bool:
    """Whether a hooked convolution has every scale its call needs."""
    q = mod.quant_scales
    return q is not None and "in_scale" in q and (not two or "in_scale2" in q)


def _qweights(mod: torch.nn.Module, c1: int | None) -> tuple:
    """The module's weight quantized per output channel (per slice at input
    channel ``c1`` for a split convolution) on its device, cached while the
    weight is unchanged (the key holds its storage and version)."""
    w = mod.weight
    key = (w.device, w.data_ptr(), w._version, c1)
    cache = getattr(mod, "_int8_weights", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            if c1 is None:
                qws = (_e.quantize_weight(w),)
            else:   # two accumulators: the slices' slabs in blocks of as many channels
                nt = _e.block_channels(w.shape[0], True)
                qws = (_e.quantize_weight(w[:, :c1], nt), _e.quantize_weight(w[:, c1:], nt))
        cache = (key, qws)
        mod._int8_weights = cache
    return cache[1]


def int8_forward(mod: torch.nn.Module, x: torch.Tensor,
                 x2: torch.Tensor | None = None) -> torch.Tensor:
    """The int8 route of a hooked convolution on the NCHW (channels_last)
    ``x`` [and ``x2``]: kernel E, output in x's dtype, NCHW view of an NHWC
    tensor."""
    if torch.is_grad_enabled() and (
            mod.weight.requires_grad or mod.bias.requires_grad or x.requires_grad
            or (x2 is not None and x2.requires_grad)):
        raise RuntimeError("the int8 convolution has no gradient (as in the JAX package): "
                           "serve under torch.no_grad() or torch.inference_mode()")
    q = mod.quant_scales
    qws = _qweights(mod, None if x2 is None else x.shape[1])
    # the NHWC view; contiguous() copies only an input that is not channels_last
    y = _e.int8_conv(
        x.permute(0, 2, 3, 1).contiguous(), qws[0], q["in_scale"], mod.bias,
        x2=None if x2 is None else x2.permute(0, 2, 3, 1).contiguous(),
        qw2=None if x2 is None else qws[1], in_scale2=q.get("in_scale2"), out_dtype=x.dtype)
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Calibration of the two serve paths
# ---------------------------------------------------------------------------

def calibrate_sample(model, inputs_batches: Iterable[torch.Tensor],
                     num_samples: int) -> Dict[str, Any]:
    """Calibrate the prior-sample serve path (``ProbabilisticUNet.sample``,
    what ``evaluate``, ``extremes`` and ``infer-domain`` serve) over
    preprocessed model inputs; returns the scales tree (CPU tensors). The
    statistics do not depend on the latent draw (no hooked convolution sees
    z), so the draws come from a CPU generator seeded 0."""
    gen = torch.Generator().manual_seed(0)
    n = 0
    with record_absmax(model) as rec, torch.no_grad():
        for x in inputs_batches:
            eps = torch.randn((num_samples, x.shape[0], model.prior.conv_mu.weight.shape[0]),
                              generator=gen, device=gen.device)
            model.sample(x, num_samples, eps=eps.to(x.device))
            n += 1
    if not n:
        raise ValueError("calibrate_sample needs at least one batch")
    return _to_cpu(quant_scales_from_stats(rec.stats()))


def calibrate_elbo(model, hr_batches: Iterable[torch.Tensor], cfg, stats) -> Dict[str, Any]:
    """Calibrate the no-grad posterior-ELBO eval path
    (``train.loop.make_eval_step``: U-Net, prior and posterior convolutions)
    over raw HR batches with the exact eval loss wiring
    (``make_elbo_loss_fn(training=False, collect_stats=True)``); returns the
    scales tree (CPU tensors). Serve with ``make_eval_step(model, cfg,
    quant=scales)``. The posterior draws come from a generator seeded 0 on
    each batch's device (the statistics do not depend on them)."""
    from probunet_tpu_torch.train.loop import make_elbo_loss_fn

    loss_fn = make_elbo_loss_fn(model, cfg, training=False, collect_stats=True)
    merged = None
    with torch.no_grad():
        for hr in hr_batches:
            _, metrics = loss_fn(hr, stats, torch.Generator(device=hr.device).manual_seed(0),
                                 1.0, 0.0)
            s = metrics["quant_stats"]
            merged = s if merged is None else merge_stats(merged, s)
    if merged is None:
        raise ValueError("calibrate_elbo needs at least one batch")
    return _to_cpu(quant_scales_from_stats(merged))


def _to_cpu(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _to_cpu(v) if isinstance(v, dict) else v.detach().cpu() for k, v in tree.items()}

