"""Mode ``evaluate``: the ``evaluate`` command's metric loop over a host
split, as a closed loop.

Traffic: a host split of ``split_days`` synthetic days (physical fields
from the seed, then the program's own dataset), visited in order in
batches of ``batch_size`` days, pass after pass. Each batch, as
``cli.cmd_evaluate`` composes it: ``get_hr_batch`` and the copy to the
card (span ``gather``), ``preprocess`` (``preprocess``), the prior
ensemble of ``members`` through ``ProbabilisticUNet.sample`` with the
benchmark's noise for that batch (``sample``), ``residual_to_hr`` and the
physical inverse of prediction and truth (``to_hr``), and
``EvalAccumulator.update``, whose (B, C) partials reach the host
(``evals``). A batch's latency runs from its gather to its partials on
the host; the next batch starts then.

Set-up runs ``warmup_batches`` batches at the same shapes. Correctness:
``checked_batches`` of the window's batches, drawn from the seed, are
recomputed by the plain reference and their per-item partials compared
(``benchmark/compare.py``).

The per-item partials are read from ``EvalAccumulator._rows`` (one dict
a ``update``, keys ``crps_pt``, ``mae_pt``, ``spread_pt``: (B, C) numpy
arrays): the program offers no public accessor of the per-item spread,
so a change to that field's name or keys breaks this mode.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import compare, harness, synth, weights

def split(cell: harness.Cell, seed: int, device: torch.device) -> np.ndarray:
    """The run's host split of physical days, from the seed."""
    tp, s = cell.params, harness.sizes(cell)
    h, w = s["resolution"]
    return synth.split_days(tp["split_days"], h, w, s["variables"],
                            torch.Generator(device=device).manual_seed(weights.mix(seed, 2)))


def checked(seed: int, n: int, k: int) -> list[int]:
    """The ``k`` of ``n`` window batches the reference recomputes."""
    rng = np.random.default_rng(weights.mix(seed, 4))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def run(run: harness.Run) -> harness.Outcome:
    from probunet_tpu_torch.data.climex import ClimexDataset, lrinterp_from_batch
    from probunet_tpu_torch.data.loader import Batches
    from probunet_tpu_torch.data.transforms import invert_physical_transform
    from probunet_tpu_torch.evals import EvalAccumulator
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    cell, dev, tp, sp = run.cell, run.device, run.cell.params, run.spans
    cfg = harness.port_config(cell)
    d = cfg.data
    b, m = tp["batch_size"], tp["members"]
    raw = split(cell, run.seed, dev)
    ds = ClimexDataset(hr=raw, variables=d.variables, pipeline=d.pipeline,
                       lowres_scale=d.lowres_scale, transfo=d.transfo,
                       interp_mode=d.interp_mode, epsilon=d.epsilon,
                       standardization=d.standardization, device=dev)
    model = ProbabilisticUNet.from_config(cfg, torch.Generator(device=dev).manual_seed(0),
                                          device=dev)
    init = weights.seeded([(n, p.shape) for n, p in model.named_parameters()], run.seed, dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    del init
    model.eval()
    order = list(Batches(len(ds), b))
    latent = cfg.model.latent_dim


    def one_batch(i: int, acc) -> None:
        idx = order[i % len(order)]
        with sp("gather"):
            hr = torch.from_numpy(ds.get_hr_batch(idx)).to(dev)
        with sp("preprocess"):
            batch = ds.preprocess(hr)
        with sp("sample"):
            eps = compare.batch_noise(run.seed, i, m, len(idx), latent, dev)
            out = model.sample(batch["inputs"], m, eps=eps)
        with sp("to_hr"):
            lrinterp = lrinterp_from_batch(batch, d.lowres_scale, d.interp_mode)
            pred = ds.residual_to_hr(out, lrinterp[:, None])
            gt = batch["hr"]
            if d.transfo:
                pred = invert_physical_transform(pred, d.variables)
                gt = invert_physical_transform(gt, d.variables)
        with sp("evals"):
            acc.update(pred, gt)

    acc = EvalAccumulator()
    times = []
    with torch.inference_mode():
        warm = EvalAccumulator()
        for i in range(tp["warmup_batches"]):
            one_batch(-1 - i, warm)
        with run.window() as t0:
            n = 0
            while not run.elapsed(t0):
                a = time.perf_counter()
                one_batch(n, acc)
                times.append(time.perf_counter() - a)
                n += 1
        with run.traced() as on:
            traced_acc = EvalAccumulator()
            for j in range(tp["traced_units"] if on else 0):
                one_batch(n + j, traced_acc)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the partials each update left on the host, one entry a batch
    rows = [{"crps": r["crps_pt"], "mae": r["mae_pt"], "spread": r["spread_pt"]}
            for r in acc._rows]
    failed = sum(not all(np.all(np.isfinite(v)) for v in r.values()) for r in rows)
    picked = checked(run.seed, n, tp["checked_batches"])
    batches = [(i, order[i % len(order)]) for i in picked]
    del model, ds, acc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    got = [rows[i] for i in picked]
    checks, ref = compare.eval_checks(cell, run, raw, batches, got)
    return harness.Outcome(
        end_to_end={"serve_member_fields_per_s": n * b * m / run.window_s,
                    "serve_batch_ms_p95": float(np.percentile(np.array(times) * 1e3, 95))
                    if times else float("nan"),
                    "peak_mem_gb": peak / 1e9},
        attempted=n, failed=failed, work={"batches": n}, checks=checks,
        facts={"memory_peak_bytes": peak, "batch": b, "members": m,
               "traced_units": tp["traced_units"] if run.profile is not None else 0,
               "compute_dtype": cfg.model.compute_dtype,
               "readings": {"program": got, "reference": ref, "batches": picked}})
