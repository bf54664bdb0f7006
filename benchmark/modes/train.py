"""Mode ``train``: the ELBO training step as the training command runs it.

Traffic: a host split of ``split_days`` synthetic days (physical fields
from the seed, then the program's own dataset: its physical transform and
statistics), shuffled index batches of ``batch_size`` epoch after epoch,
each gathered on the host and prefetched ``prefetch`` deep to the card
(``data.loader.Batches``, ``ClimexDataset.get_hr_batch``,
``prefetch_to_device``), and ``train.loop.make_train_step``'s step on
every batch, with the posterior noise and the dropout seed words drawn by
the benchmark from the seed.

Set-up builds the one training state, loads the seeded weights and
drives it through the first ``check_steps`` steps of the same feed; those
steps warm every shape. The window runs the same step on the same feed.
Correctness: the plain reference (``benchmark/reference``) follows the
same first steps from the same weights, batches, noise and seed words, and
``benchmark/compare.py`` holds the losses, the first gradient (from the
optimizer's first moment after one step) and the parameters' change after
the check steps against it.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from benchmark import compare, harness, synth, weights


def _batches(n: int, batch_size: int, seed: int, record: list):
    """Shuffled index batches, epoch after epoch (each epoch's order from
    the seed and the epoch), each recorded as it is gathered."""
    from probunet_tpu_torch.data.loader import Batches

    epoch = 0
    while True:
        for idx in Batches(n, batch_size, shuffle=True, seed=weights.mix(seed, 100 + epoch)):
            record.append(idx)
            yield idx
        epoch += 1


def _noise(gen: torch.Generator, members: int, batch: int, latent: int, blocks: int):
    eps = torch.randn((members, batch, latent), generator=gen, device=gen.device)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (blocks, 2), generator=gen, device=gen.device,
                          dtype=torch.int32)
    return eps, seeds


def check_inputs(cell: harness.Cell, seed: int, device: torch.device, blocks: int):
    """The raw split, the check steps' day indices and their (noise, seed
    words), as a run of ``seed`` makes them (the limits' control reads
    them without running the program)."""
    tp, s = cell.params, harness.sizes(cell)
    h, w = s["resolution"]
    raw = synth.split_days(tp["split_days"], h, w, s["variables"],
                           torch.Generator(device=device).manual_seed(weights.mix(seed, 2)))
    seen: list = []
    batches = _batches(raw.shape[0], tp["batch_size"], seed, seen)
    idx = [next(batches) for _ in range(tp["check_steps"])]
    gen = torch.Generator(device=device).manual_seed(weights.mix(seed, 3))
    noise = [_noise(gen, tp["members"], tp["batch_size"], s["latent_dim"], blocks)
             for _ in idx]
    return raw, idx, noise


def run(run: harness.Run) -> harness.Outcome:
    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.data.loader import prefetch_to_device
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.train.loop import make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    cell, dev, tp, sp = run.cell, run.device, run.cell.params, run.spans
    cfg = harness.port_config(cell)
    d = cfg.data
    b, m = tp["batch_size"], tp["members"]
    cfg.train.batch_size, cfg.train.ensemble_size = b, m
    h, w = d.resolution
    raw = synth.split_days(tp["split_days"], h, w, d.variables,
                           torch.Generator(device=dev).manual_seed(weights.mix(run.seed, 2)))
    ds = ClimexDataset(hr=raw, variables=d.variables, pipeline=d.pipeline,
                       lowres_scale=d.lowres_scale, transfo=d.transfo,
                       interp_mode=d.interp_mode, epsilon=d.epsilon,
                       standardization=d.standardization, device=dev)
    stats = ds.device_stats(dev)
    model = ProbabilisticUNet.from_config(cfg, torch.Generator(device=dev).manual_seed(0),
                                          device=dev)
    names = [n for n, _ in model.named_parameters()]
    init = weights.seeded([(n, p.shape) for n, p in model.named_parameters()], run.seed, dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    del init
    state = create_train_state(model, seed=cfg.train.seed, lr=cfg.train.lr,
                               weight_decay=cfg.train.weight_decay, device=dev)
    step = make_train_step(model, cfg)
    beta_0, beta_1 = tp["beta_0"], tp["beta_1"]
    blocks = len(model.unet.dropout_blocks)
    gen = torch.Generator(device=dev).manual_seed(weights.mix(run.seed, 3))
    seen: list[np.ndarray] = []
    feed = prefetch_to_device((ds.get_hr_batch(idx) for idx in
                               _batches(len(ds), b, run.seed, seen)),
                              size=tp["prefetch"], device=dev)

    # the check steps: the window's call and feed, from the seeded weights
    params = state.optimizer.params
    p0 = [p.detach().clone() for p in params]
    noise, losses = [], []
    for k in range(tp["check_steps"]):
        eps, seeds = _noise(gen, m, b, cfg.model.latent_dim, blocks)
        noise.append((eps, seeds))
        state, out = step(state, next(feed), stats, beta_0, beta_1, eps, seeds)
        losses.append((out["loss"], out["recon"], out["kl_mean"]))
        if k == 0:
            scale = 1.0 - state.optimizer.b1
            grad_norms = [torch.linalg.vector_norm(mu) / scale for mu in state.optimizer.mu]
    change = [torch.linalg.vector_norm(p.detach() - q) for p, q in zip(params, p0)]
    program = {"loss": [float(x[0]) for x in losses], "recon": [float(x[1]) for x in losses],
               "kl": [float(x[2]) for x in losses],
               "grad": dict(zip(names, (float(x) for x in grad_norms))),
               "change": dict(zip(names, (float(x) for x in change)))}
    check_idx = seen[:tp["check_steps"]]
    del p0

    window_losses = []
    with run.window() as t0:
        n = 0
        while not run.elapsed(t0):
            with sp("loader"):
                hr = next(feed)
            eps, seeds = _noise(gen, m, b, cfg.model.latent_dim, blocks)
            with sp("step"):
                state, out = step(state, hr, stats, beta_0, beta_1, eps, seeds)
            window_losses.append(out["loss"])
            del hr, out
            n += 1
    with run.traced() as on:
        for _ in range(tp["traced_units"] if on else 0):
            with sp("loader"):
                hr = next(feed)
            eps, seeds = _noise(gen, m, b, cfg.model.latent_dim, blocks)
            with sp("step"):
                state, out = step(state, hr, stats, beta_0, beta_1, eps, seeds)
            del hr, out
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = (int((~torch.isfinite(torch.stack(window_losses))).sum()) if window_losses
              else 0)
    feed.close()
    del feed, state, step, model, ds, stats, params, window_losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks, ref = compare.train_checks(cell, run, raw, check_idx, noise, program)
    return harness.Outcome(
        end_to_end={"train_samples_per_s": n * b / run.window_s,
                    "peak_mem_gb": peak / 1e9},
        attempted=n, failed=failed, work={"steps": n}, checks=checks,
        facts={"memory_peak_bytes": peak, "batch": b, "members": m,
               "traced_units": tp["traced_units"] if run.profile is not None else 0,
               "compute_dtype": cfg.model.compute_dtype,
               "readings": {"program": program, "reference": ref}})
