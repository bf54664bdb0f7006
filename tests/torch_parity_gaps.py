"""Two of the port's checks against itself and the JAX package that sit
near their bounds, taken apart (ROADMAP.md §3). Run from the repository's
root:

    python tests/torch_parity_gaps.py chains
    python tests/torch_parity_gaps.py gates [SEED]
    python tests/torch_parity_gaps.py steps [--continued] [--jax-stats] SEED ...
    python tests/torch_parity_gaps.py ingest [--jax-stats]

The first three take apart the spatially sharded step's "kernel A" case
(``test_torch_parallel_spatial_steps.py``: the tiny model at 32x32 with
``num_filters=(32, 16)``, so Fcomb width 32 takes kernel A's route;
dropout 0.1; GroupNorm on split C/C′; a 1 x 2 mesh of gloo ranks on the
CPU) against the one-process step.

``chains``: every GroupNorm chain of the one-process step, recorded, then
run split into its two row blocks with the plain split C/C′ (seed words
shifted by ``slab_seed``, each block placed at its rows among zero rows
and the blocks added as the ranks' all-reduce adds them): (H, W, C, G),
the keep masks' differing elements, and the largest difference of mean,
rstd, y, dx, dgamma, dbeta, dscale and dshift over the largest element.

``gates``: kernel A's inputs (the Fcomb features' projection and the
latents' part) on both routes at steps 0 and 1, the elements where a ReLU
gate of Fcomb's hidden layers (h0 > 0, h1 > 0) or a sign of the CRPS
terms differs between the routes, with the pre-activations there, and how
far A′'s outputs part.

``steps``: the case's step-0 and step-1 gaps for each data seed of
``hr_fields`` (21 is the test's), each step from the state the test starts
it from (step 1 from the one-process step's state after step 0): the
largest gradient difference over the largest gradient, the grad_norm
difference over the test's bound (rtol 1e-5), and whether the step passes
the test's checks (the metrics within RTOL, the gradients within
GRAD_RTOL); then the number of seeds failing at each step.
``--continued`` runs the comparison the test made before: the sharded
run's step 1 from its own state after its step 0. The split plain C/C′
and the encoders' global mean gather the image (a block placed among zero
rows and summed over the ranks), so the sharded forward is the
one-process forward bit for bit from a shared state.

``ingest``: ``test_torch_ingest.py::test_dataset_from_packed_with_crop``'s
worst margin (|port - JAX| over the test's bound, 1e-6 + 1e-6 |JAX|) for
``hr`` and each statistic, both ``transfo`` cases.

``--jax-stats`` (``steps``, ``ingest``): ``compute_stats``' time mean and
std at the JAX package's rounding points as XLA computes them on the CPU
for up to 32 days: the days added in order, times f32(1 / T) and
f32(1 / (T - 1)).
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS.parent), str(TESTS)]

WIDE = (32, 16)
JAX_STATS_ENV = "PARITY_GAPS_JAX_STATS"


def _case(seed: int, steps: int = 2) -> dict:
    from torch_spatial import DROPOUT, M, hr_fields, params

    return dict(name="kernel A", hr=hr_fields(seed), m=M, fused=True, eps=None, steps=steps,
                n_data=1, n_spatial=2, dropout=DROPOUT, gn_impl="kernel", num_filters=WIDE,
                params=params(WIDE))


def _rel(got, want) -> float:
    d = float((got.double() - want.double()).abs().max())
    m = float(want.abs().max())
    return d / m if m else d


# ---------------------------------------------------------------------------
# --jax-stats: compute_stats' time mean and std in XLA's order
# ---------------------------------------------------------------------------

def use_jax_stats() -> None:
    """Patch ``compute_stats`` to take the time mean and std as XLA does."""
    import numpy as np

    from probunet_tpu_torch.data import climex

    plain = climex.compute_stats

    def days_sum(x):
        acc = torch.zeros_like(x[0])
        for day in x:
            acc += day
        return acc

    def compute_stats(hr, lowres_scale):
        st = plain(hr, lowres_scale)
        lr = climex.avg_pool(hr, lowres_scale)
        t = lr.shape[0]
        mean = days_sum(lr) * torch.tensor(float(np.float32(1.0 / t)))
        inv = torch.tensor(float(np.float32(1.0 / (t - 1))))
        std = torch.sqrt(days_sum((lr - mean) ** 2) * inv)
        lift = climex.repeat_interleave_2d
        return st._replace(lr_mean=mean, lr_std=std, hr_mean=lift(mean, lowres_scale),
                           hr_std=lift(std, lowres_scale))

    climex.compute_stats = compute_stats


def _patches() -> None:
    if os.environ.get(JAX_STATS_ENV):
        use_jax_stats()


# ---------------------------------------------------------------------------
# The ranks: the case's steps, kernel A's inputs recorded
# ---------------------------------------------------------------------------

def _record_kernel_a(store: list) -> None:
    """Append kernel A's seven inputs at each forward, and to the same
    entry A′'s outputs (dfeat, dz, dW1, db1, dW2, db2) at its backward."""
    from probunet_tpu_torch.ops.kernels import fcomb_crps as fc

    fwd, bwd = fc.fcomb_crps_terms_fwd, fc.fcomb_crps_terms_bwd

    def recorded(*args):
        store.append([a.detach().clone() for a in args[:7]])
        return fwd(*args)

    def recorded_bwd(*args, **kwargs):
        grads = bwd(*args, **kwargs)
        store[-1].append([t.clone() for t in grads[:6]])
        return grads

    fc.fcomb_crps_terms_fwd, fc.fcomb_crps_terms_bwd = recorded, recorded_bwd


def _worker() -> None:
    import torch_mp_worker as w

    _patches()
    store: list = []
    _record_kernel_a(store)

    def gap(workdir, job):
        w.spatial_step(workdir, "spatial_step")
        torch.save(store, os.path.join(workdir, f"kernel_a.rank{w.RANK}.pt"))

    w.JOBS["gap"] = gap
    w.main()


def _runs(case: dict, continued: bool = False):
    """(the sharded run's rank-0 outputs, kernel A's inputs on each rank, the
    one-process metrics, gradients and kernel A inputs). The sharded run
    takes each step after the first from the one-process step's state
    there, or with ``continued`` from its own."""
    import torch_mp
    from torch_spatial import one_process, params

    store: list = []
    _record_kernel_a(store)
    states: list = []
    one = one_process(case, states=states)[:2]
    if not continued:
        case = dict(case, starts=[None, *states[1:]])
    with tempfile.TemporaryDirectory() as wd:
        torch.save({"params": params(), "cases": [case]}, Path(wd) / "spatial_step.in.pt")
        worker, torch_mp.WORKER = torch_mp.WORKER, str(Path(__file__).resolve())
        try:
            torch_mp.spawn(["gap"], wd, world=2, timeout=600)
        finally:
            torch_mp.WORKER = worker
        out = torch.load(Path(wd) / "spatial_step.rank0.pt", weights_only=False)[case["name"]]
        ranks = [torch.load(Path(wd) / f"kernel_a.rank{r}.pt") for r in (0, 1)]
    return out, ranks, (*one, store)


# ---------------------------------------------------------------------------
# The reports
# ---------------------------------------------------------------------------

def chains() -> None:
    from torch_spatial import one_process

    from probunet_tpu_torch.ops.kernels import fused_gn as fg

    calls = {"fwd": [], "bwd": []}
    plain = {"fwd": fg.gn_film_silu_dropout_fwd, "bwd": fg.gn_film_silu_dropout_bwd}

    def recorder(kind):
        def run(*args):
            calls[kind].append([a.clone() if isinstance(a, torch.Tensor) else a for a in args])
            return plain[kind](*args)
        return run

    fg.gn_film_silu_dropout_fwd, fg.gn_film_silu_dropout_bwd = recorder("fwd"), recorder("bwd")
    one_process(_case(21, steps=1))
    fg.gn_film_silu_dropout_fwd, fg.gn_film_silu_dropout_bwd = plain["fwd"], plain["bwd"]

    def two_blocks(run):
        parts = []
        for i in (0, 1):
            run(i, lambda t: parts.append(t.clone()))
        return [run(i, lambda t: t.copy_(parts[0] + parts[1])) for i in (0, 1)]

    print(f"{len(calls['fwd'])} chains on C's route (the encoders have none)")
    for i, fa in enumerate(calls["fwd"]):
        x, gamma, beta, scale, shift, seed2, groups, eps, p, silu = fa
        ba = next(a for a in calls["bwd"] if a[0].shape == x.shape and torch.equal(a[0], x))
        b, h, w, c = x.shape
        hb = h // 2
        seeds = [fg.slab_seed(seed2, 0, r * hb * w * c) for r in (0, 1)]
        rows = [slice(r * hb, (r + 1) * hb) for r in (0, 1)]
        y, mean, rstd = plain["fwd"](*fa)
        got = two_blocks(lambda r, red: fg.gn_split_fwd_plain(
            x[:, rows[r]].contiguous(), gamma, beta, scale, shift, seeds[r], groups, eps, p,
            silu, h, red, r * hb))
        masks = "-" if p == 0 else int((torch.cat([fg.gn_keep(x[:, r].shape, s, p) for r, s in
                                                   zip(rows, seeds)], 1)
                                        != fg.gn_keep(x.shape, seed2, p)).sum())
        g = ba[1]
        want = plain["bwd"](x, g, *fa[1:6], mean, rstd, groups, p, silu)
        back = two_blocks(lambda r, red: fg.gn_split_bwd_plain(
            x[:, rows[r]].contiguous(), g[:, rows[r]].contiguous(), gamma, beta, scale, shift,
            seeds[r], mean, rstd, groups, p, silu, h, red, r * hb))
        diffs = {"mean": _rel(got[0][1], mean), "rstd": _rel(got[0][2], rstd),
                 "y": _rel(torch.cat([o[0] for o in got], 1), y),
                 "dx": _rel(torch.cat([o[0] for o in back], 1), want[0])}
        for j, name in enumerate(("dgamma", "dbeta", "dscale", "dshift"), start=1):
            diffs[name] = _rel(back[0][j] + back[1][j], want[j])
        print(f"chain {i:2d} (H, W, C, G) = ({h}, {w}, {c}, {groups}) p={p} mask diffs {masks} "
              + " ".join(f"{k} {v:.2e}" for k, v in diffs.items()))


def _decode(feat, z, w1, b1, w2, b2):
    h0 = feat[:, None] + z.permute(0, 2, 1)[..., None]               # (B, M, C, P)
    h1 = torch.matmul(w1.T, torch.relu(h0)) + b1[:, None]
    return h0, h1, torch.matmul(w2.T, torch.relu(h1)) + b2[:, None]   # (B, M, K, P)


def gates(seed: int = 21) -> None:
    _, ranks, (_, _, one) = _runs(_case(seed))
    for step, whole in enumerate(one):
        split = [torch.cat([r[step][0] for r in ranks], dim=2), *ranks[0][step][1:6],
                 torch.cat([r[step][6] for r in ranks], dim=2)]
        print(f"step {step}: kernel A's inputs, elements that differ: feat "
              f"{int((split[0] != whole[0]).sum())}/{whole[0].numel()} (largest "
              f"{float((split[0] - whole[0]).abs().max()):.3e}), latents "
              f"{int((split[1] != whole[1]).sum())}/{whole[1].numel()}")
        out = {}
        for name, args in (("whole", whole), ("split", split)):
            h0, h1, x = _decode(*args[:6])
            m = x.shape[1]
            out[name] = {"h0": h0, "h1": h1, "sign(x - y)": torch.sign(x - args[6][:, None]),
                         "sign(x_i - x_j)": torch.stack([torch.sign(x[:, i] - x[:, j])
                                                         for i in range(m)
                                                         for j in range(i + 1, m)])}
        for key in out["whole"]:
            a, b = out["whole"][key], out["split"][key]
            flips = (a > 0) != (b > 0) if key in ("h0", "h1") else a != b
            at = [tuple(i) for i in torch.nonzero(flips).tolist()]
            vals = "; ".join(f"(b, m, c, p) = {i}: {float(a[i]):.3e} one process, "
                             f"{float(b[i]):.3e} sharded" for i in at[:4] if key in ("h0", "h1"))
            print(f"  {key}: {len(at)} elements differ" + (f": {vals}" if vals else ""))
        # A′'s outputs: each rank's gradient is the number of ranks (2) times its
        # block's part (every rank differentiates the whole loss); dfeat is per pixel
        dfeat = torch.cat([r[step][7][0] for r in ranks], dim=2) / 2
        big = (dfeat - whole[7][0]).abs() > 1e-3 * whole[7][0].abs().max()
        terms = {name: _rel((ranks[0][step][7][i] + ranks[1][step][7][i]) / 2, whole[7][i])
                 for i, name in enumerate(("dz", "dW1", "db1", "dW2", "db2"), start=1)}
        print(f"  A′: dfeat {_rel(dfeat, whole[7][0]):.3e} of its largest, {int(big.sum())} "
              "elements beyond 1e-3 of it; " + ", ".join(f"{k} {v:.3e}" for k, v in terms.items()))


def steps(seeds: list[int], what: str, continued: bool) -> None:
    from test_torch_parallel_spatial_steps import GRAD_RTOL, RTOL

    failed = {0: [], 1: []}
    for seed in seeds:
        out, _, (mets, grads, _) = _runs(_case(seed), continued)
        row = []
        for i in range(len(mets)):
            err = max(float((a - b).abs().max()) for a, b in zip(out["grads"][i], grads[i]))
            err /= max(float(b.abs().max()) for b in grads[i])
            gaps = {k: abs(float(out["metrics"][i][k]) - float(v)) / (RTOL * abs(float(v)))
                    for k, v in mets[i].items() if k in ("loss", "recon", "kl_mean", "grad_norm")}
            ok = err <= GRAD_RTOL[i] and max(gaps.values()) <= 1.0
            if not ok:
                failed[i].append(seed)
            row.append(f"step {i}: gradients {err:.3e} of the largest, grad_norm "
                       f"{gaps['grad_norm']:.3f} of its bound, worst metric "
                       f"{max(gaps, key=gaps.get)} {max(gaps.values()):.3f}, "
                       + ("passes" if ok else "FAILS"))
        print(f"seed {seed}{what}: " + "; ".join(row), flush=True)
    print(f"{what.strip() or 'shared state'}: " + "; ".join(
        f"step {i} fails on {len(v)} of {len(seeds)} seeds {v}" for i, v in failed.items()))


def ingest() -> None:
    import numpy as np
    import test_torch_ingest as t

    from probunet_tpu_torch.data import climex

    def margin(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float((np.abs(got - want) / (t.STAT_TOL + t.STAT_TOL * np.abs(want))).max())

    for transfo in (False, True):
        with tempfile.TemporaryDirectory() as wd:
            hr = t.synthetic_climex_fields(30, 24, 24, t.VARS, seed=4)
            climex.save_packed(f"{wd}/big.npz", hr, *t.synthetic_timestamps(30, 1990))
            np.save(f"{wd}/small.npy", hr[:, :16, :16])
            kw = dict(packed=f"{wd}/big.npz", variables=t.VARS, coords=(4, 20, 6, 22),
                      pipeline="lrinterp_to_residuals", lowres_scale=4, transfo=transfo)
            worst = {}
            for source in ("npz", "npy"):
                got, want = t._torch_ds(**kw), t._jax_ds(**kw)
                for name in ("hr", *climex.Standardization._fields):
                    a, b = ((got.hr, want.hr) if name == "hr"
                            else (getattr(got.stats, name), getattr(want.stats, name)))
                    worst[f"{source} {name}"] = margin(a, b)
                kw.update(packed=f"{wd}/small.npy", years=range(2001, 2002))
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
        print(f"transfo={transfo}: worst margins " + ", ".join(f"{k} {v:.4f}" for k, v in top))


def main(argv: list[str]) -> None:
    torch.set_num_threads(1)
    what, rest = argv[0], argv[1:]
    if what == "chains":
        chains()
    elif what in ("gates", "steps", "ingest"):
        flags = {"--jax-stats": JAX_STATS_ENV}
        for flag, env in flags.items():
            if flag in rest:
                os.environ[env] = "1"   # the ranks read it too
        _patches()
        continued = "--continued" in rest
        seeds = [int(s) for s in rest if s not in flags and s != "--continued"] or [21]
        if what == "ingest":
            ingest()
        elif what == "gates":
            gates(seeds[0])
        else:
            steps(seeds, "".join(f" {f[2:]}" for f in [*flags, "--continued"] if f in rest),
                  continued)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    if "RANK" in os.environ:   # one of the ranks torch_mp.spawn starts
        _worker()
    else:
        main(sys.argv[1:] or ["chains"])
