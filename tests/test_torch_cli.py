"""The port's command line (``pack``, ``evaluate``, ``extremes``,
``infer-domain``, the int8 serving flags) against the
JAX package, on the tiny overrides of ``tests/test_cli.py`` (16x16,
preset ``probunet_latent6_64``) under ``PROBUNET_PLATFORM=cpu``.

The port serves a checkpoint of the JAX model's noisy parameters
(``tests/torch_parity.py``) converted by ``convert.load_params``. The JAX
side is a loop of the JAX package's own functions (its ``make_datasets``
and ``make_model``, ``encode``/``decode`` with the port's per-batch noise
``cli.batch_noise``, ``residual_to_hr``, its ``EvalAccumulator`` and GEV
analyses), so both score the same ensembles up to f32 rounding.

Tolerances: the JSON numbers rtol 1e-4 / atol 1e-5 (the model-level
tolerance of ``test_torch_models.py``: the same weights and noise through
two libraries' convolutions); histogram counts exact; the annual maxima,
GEV fits, return levels and plateaus rtol 1e-4 (fits of series that agree
to that tolerance); the packed arrays exact. The bootstrap intervals of
the two runs are not compared with each other: each is a quantile over
refits of resampled series, each refit a Nelder-Mead search, and a fit
that moves by 1e-7 can send one refit to another optimum (one quantile
moved by 19% in a trial). The port's intervals must instead equal, bit for
bit, those the JAX package's bootstrap computes from the port's own fit.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import assert_close, noisy_params
from torch_parity import torch_one_thread  # noqa: F401  (fixture)

from probunet_tpu_torch import cli as tcli
from probunet_tpu_torch.evals.streaming import EvalAccumulator, _batch_hist

pytestmark = pytest.mark.usefixtures("torch_one_thread")

RTOL, ATOL = 1e-4, 1e-5
PRESET = "probunet_latent6_64"
TINY = [
    "--set",
    'data.resolution=[16,16]', 'data.coords=[0,16,0,16]',
    "data.lowres_scale=4",
    'data.years_train=[1960,1961]', 'data.years_val=[1961,1962]',
    'data.years_test=[1962,1963]',
    'model.num_filters=[8,16]', "model.model_channels=8",
    'model.channel_mult=[1,2]', "model.num_blocks=1", "model.latent_dim=4",
]
EVAL = ["--members", "4", "--batch-size", "16", "--max-items", "64"]
EXTREMES = ["--pixels", "3,4", "8,8", "--members", "3", "--batch-size", "64",
            "--days", "360", "--days-per-year", "30", "--n-boot", "10",
            "--return-periods", "2", "5", "10"]


def _jax_cfg(extra=()):
    from probunet_tpu.cli import build_config

    return build_config(argparse.Namespace(preset=PRESET, config=None,
                                           set=TINY[1:] + list(extra)))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX model, its noisy params, the port's checkpoint directory)."""
    import jax
    import jax.numpy as jnp
    from flax.core import unfreeze

    from probunet_tpu.cli import make_model

    from probunet_tpu_torch.config import preset
    from probunet_tpu_torch.convert import load_params
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet
    from probunet_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _jax_cfg()
    jmodel = make_model(cfg)
    x = jnp.zeros((1, 16, 16, 1))
    shapes = jax.eval_shape(lambda k: jmodel.init({"params": k, "latent": k}, x, x),
                            jax.random.key(0))
    params = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                       unfreeze(shapes["params"])), seed=3)
    tcfg = preset(PRESET).override(tcli._parse_overrides(TINY[1:]))
    model = ProbabilisticUNet.from_config(tcfg, torch.Generator().manual_seed(0), device="cpu")
    load_params(model, params)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    CheckpointManager(ckpt).save_best(model.state_dict())
    return jmodel, params, ckpt


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv("PROBUNET_PLATFORM", "cpu")


def _jax_sampler(jmodel, params, cfg, ds):
    """jitted (hr batch, eps) -> (hr_pred, gt): the JAX CLI's sample step
    with the prior noise given."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import lrinterp_from_batch, residual_to_hr
    from probunet_tpu.data.transforms import invert_physical_transform

    stats = jax.tree.map(jnp.asarray, ds.stats)
    p = jax.tree.map(jnp.asarray, params)

    def decode(mdl, x, eps):
        feats, prior, _ = mdl.encode(x)
        return mdl.decode(feats, prior.mu + prior.sigma * eps)

    @jax.jit
    def sample_hr(hr_batch, eps):
        batch = ds.preprocess(hr_batch)
        out = jmodel.apply({"params": p}, batch["inputs"], eps, method=decode)
        lrinterp = lrinterp_from_batch(batch, cfg.data.lowres_scale, cfg.data.interp_mode)
        hr_pred = residual_to_hr(out, lrinterp[:, None], stats, ds.pipeline,
                                 cfg.data.epsilon, cfg.data.standardization)
        gt = batch["hr"]
        if cfg.data.transfo:
            hr_pred = invert_physical_transform(hr_pred, cfg.data.variables)
            gt = invert_physical_transform(gt, cfg.data.variables)
        return hr_pred, gt

    return lambda idx, eps: sample_hr(jnp.asarray(ds.get_hr_batch(idx)), jnp.asarray(eps))


def _jax_ensembles(jmodel, params, n_items, bs, m, seed):
    from probunet_tpu.cli import make_datasets
    from probunet_tpu.data.loader import Batches

    cfg = _jax_cfg()
    _, _, ds = make_datasets(cfg, splits=(2,))
    sample = _jax_sampler(jmodel, params, cfg, ds)
    n = min(len(ds), n_items or len(ds))
    for i, idx in enumerate(Batches(n, bs)):
        eps = tcli.batch_noise(seed, i, m, len(idx), cfg.model.latent_dim).numpy()
        yield sample(idx, eps)


def _capture_results(monkeypatch):
    """The port's ``EvalAccumulator.result`` outputs of the next commands."""
    results = []
    result = EvalAccumulator.result

    def keep(self):
        results.append(result(self))
        return results[-1]

    monkeypatch.setattr(EvalAccumulator, "result", keep)
    return results


def test_evaluate_matches_jax(served, on_cpu, tmp_path, monkeypatch, capsys):
    from probunet_tpu.evals import EvalAccumulator as JaxAcc

    jmodel, params, ckpt = served
    results = _capture_results(monkeypatch)
    out = str(tmp_path / "ev")
    got, spans = tcli.main(["evaluate", "--preset", PRESET, "--outdir", out,
                            "--ckpt", ckpt] + EVAL + TINY)
    printed = capsys.readouterr().out
    assert json.loads([ln for ln in printed.splitlines() if '"crps_mean"' in ln][-1]) == got
    with open(os.path.join(out, "eval.json")) as f:
        assert json.load(f) == got
    assert list(spans) == ["dataset", "init", "metric_loop", "hist_loop", "figures"]
    assert "[timing] dataset=" in printed

    acc = JaxAcc()
    for e, g in _jax_ensembles(jmodel, params, 64, 16, 4, tcli.EVAL_SEED):
        acc.update(e, g)
    for e, g in _jax_ensembles(jmodel, params, 64, 16, 4, tcli.EVAL_SEED):
        acc.update_hist(e, g)
    want = acc.result()
    assert got["members"] == 4 and got["items"] == want["items"] == 64
    for key, ref in (("crps_mean", want["crps"]["mean"]), ("crps_std", want["crps"]["std"]),
                     ("mae_mean", want["mae"]["mean"]), ("spread", want["spread"])):
        assert len(got[key]) == 1
        assert_close(got[key], ref, RTOL, ATOL, key)
    hist = results[-1]["hist"]
    assert_close(hist["lo"], want["hist"]["lo"], RTOL, ATOL, "lo")
    assert_close(hist["hi"], want["hist"]["hi"], RTOL, ATOL, "hi")
    for key in ("gt_counts", "model_counts"):
        assert np.array_equal(hist[key], want["hist"][key]), key
    assert_close(results[-1]["psd_model"], want["psd_model"], RTOL,
                 ATOL * float(np.abs(want["psd_model"]).max()), "psd_model")


def test_two_pass_histogram_equals_the_materialized_ensembles(served, on_cpu, tmp_path,
                                                              monkeypatch):
    """The second pass regenerates the first pass's ensembles: its counts
    equal the histogram of all batches' ensembles held at once."""
    from probunet_tpu_torch.data.loader import Batches

    _, _, ckpt = served
    results = _capture_results(monkeypatch)
    tcli.main(["evaluate", "--preset", PRESET, "--outdir", str(tmp_path),
               "--ckpt", ckpt] + EVAL + TINY)
    hist = results[-1]["hist"]
    args = argparse.Namespace(preset=PRESET, config=None, set=TINY[1:])
    cfg = tcli.build_config(args)
    _, _, ds = tcli.make_datasets(cfg, splits=(2,), device="cpu")
    model = tcli._load_model(cfg, ckpt, torch.device("cpu"))
    ens, gts = [], []
    with torch.inference_mode():
        for i, idx in enumerate(Batches(64, 16)):
            e, g = tcli._sample_hr(model, ds, cfg, idx,
                                   tcli.batch_noise(tcli.EVAL_SEED, i, 4, 16, 4))
            ens.append(e)
            gts.append(g)
    lo = torch.from_numpy(hist["lo"]).float()
    hi = torch.from_numpy(hist["hi"]).float()
    ens, gts = torch.cat(ens), torch.cat(gts)
    assert float(torch.minimum(ens.amin(), gts.amin())) == float(lo.min())
    assert np.array_equal(hist["model_counts"], _batch_hist(ens, lo, hi, 100).numpy())
    assert np.array_equal(hist["gt_counts"], _batch_hist(gts, lo, hi, 100).numpy())
    assert hist["gt_counts"].sum() == gts.numel()


def _jax_extremes(jmodel, params, days, bs, m, pixels, periods, days_per_year, n_boot):
    """(days served, {pixel: {"observed", "model"} analyses}) of the JAX
    loop; its bootstrap intervals are not compared (module docstring)."""
    from probunet_tpu.evals import model_ensemble_analysis, return_level_analysis

    seed = _jax_cfg().train.seed
    ys = np.array([p[0] for p in pixels])
    xs = np.array([p[1] for p in pixels])
    mv, gv = [], []
    for e, g in _jax_ensembles(jmodel, params, days, bs, m, seed):
        mv.append(np.asarray(e)[:, :, ys, xs, 0])
        gv.append(np.asarray(g)[:, ys, xs, 0])
    model_series, gt_series = np.concatenate(mv), np.concatenate(gv)
    out = {}
    for pi, (py, px) in enumerate(pixels):
        obs = return_level_analysis(gt_series[:, pi], periods, days_per_year,
                                    n_boot=n_boot, seed=seed)
        mod = model_ensemble_analysis(model_series[:, :, pi], periods, days_per_year,
                                      n_boot=n_boot, seed=seed)
        out[f"pixel_{py}_{px}"] = {"observed": obs, "model": mod}
    return model_series.shape[0], out


def test_extremes_matches_jax(served, on_cpu, tmp_path, capsys):
    from probunet_tpu.evals import gev as jgev

    jmodel, params, ckpt = served
    seed = _jax_cfg().train.seed
    out = str(tmp_path / "ext")
    got, spans = tcli.main(["extremes", "--preset", PRESET, "--outdir", out,
                            "--ckpt", ckpt] + EXTREMES + TINY)
    printed = capsys.readouterr().out
    assert json.loads([ln for ln in printed.splitlines() if '"pixels"' in ln][-1]) == got
    with open(os.path.join(out, "extremes.json")) as f:
        assert json.load(f) == got
    assert list(spans) == ["dataset", "init", "sample_loop", "gev_fits"]
    # drop-last static batching: 5 batches of 64 of the 360 days asked
    assert got["days"] == 320 and got["days_requested"] == 360
    assert got["members"] == 3 and got["variable"] == "pr"
    days, want = _jax_extremes(jmodel, params, 360, 64, 3, [(3, 4), (8, 8)], (2, 5, 10),
                               30, n_boot=2)
    assert days == got["days"]
    assert set(got["pixels"]) == set(want)
    for name, ref in want.items():
        g = got["pixels"][name]
        for side in ("observed", "model"):
            r = ref[side]
            assert_close(g[side]["block_maxima"], r["block_maxima"], RTOL, ATOL,
                         f"{name} {side} block maxima")
            assert_close(g[side]["gev_fit"], list(r["fit"]), RTOL, ATOL, f"{name} {side} fit")
            assert_close(g[side]["return_levels"], r["return_levels"], RTOL, ATOL,
                         f"{name} {side} levels")
            n_fit = np.asarray(g[side]["block_maxima"]).size
            boot = jgev.gev_parametric_bootstrap(jgev.GEVFit(*g[side]["gev_fit"]), n_fit,
                                                 (2, 5, 10), n_boot=10, seed=seed)
            assert g[side]["ci_lower"] == boot["lower"].tolist()
            assert g[side]["ci_upper"] == boot["upper"].tolist()
            assert g[side]["bootstrap_valid"] == boot["n_valid"]
            assert g[side]["bootstrap_failed"] == boot["n_failed"]
        assert_close(g["model"]["empirical_plateau"], r["empirical_levels"].max(), RTOL,
                     ATOL, "plateau")
    assert np.asarray(g["model"]["block_maxima"]).shape == (days // 30, 3)


def test_pack_matches_jax(on_cpu, tmp_path, capsys):
    from probunet_tpu.cli import main as jax_main

    paths = {"torch": str(tmp_path / "t.npz"), "jax": str(tmp_path / "j.npz")}
    got = tcli.main(["pack", "--preset", PRESET, "--split", "test",
                     "--out", paths["torch"]] + TINY)
    jax_main(["pack", "--preset", PRESET, "--split", "test", "--out", paths["jax"]] + TINY)
    assert got == {"packed": paths["torch"], "shape": [365, 16, 16, 1]}
    with np.load(paths["torch"]) as t, np.load(paths["jax"]) as j:
        assert t.files == j.files
        for key in j.files:
            assert t[key].dtype == j[key].dtype and np.array_equal(t[key], j[key]), key
    # the artifact serves: evaluate reads it through data.packed_test
    got, _ = tcli.main(["evaluate", "--preset", PRESET, "--outdir", "", "--members", "2",
                        "--max-items", "16"] + TINY + [f"data.packed_test={paths['torch']}"])
    assert got["items"] == 16


# The parallel flags on two gloo ranks spawned on the CPU (``tests/torch_mp.py``),
# every run of the module in one spawn, each against the one-process command.
# Tolerance: the JSON numbers rtol 1e-5 / atol 1e-6 (the same arithmetic on
# half the batch or the members: convolutions of another batch size may round
# differently); the training history, which compounds two half-batch gradients
# over five steps, RTOL / ATOL.
PAR_RTOL, PAR_ATOL = 1e-5, 1e-6
# the members split over 2 ranks; one bootstrap draw (the intervals are not
# compared, see the module's docstring)
PAR_EXTREMES = EXTREMES + ["--members", "4", "--n-boot", "1"]


def _two_rank_argvs(ckpt, tmp):
    train = ["--preset", PRESET] + TINY + TRAIN[1:] + ["train.num_epochs=1"]
    serve = ["--preset", PRESET, "--ckpt", ckpt]
    infer = INFER[:-1] + ["7"]    # chunks of 7 tiles round up to 8 over two ranks
    return {
        "evaluate": ["evaluate", "--outdir", "", "--member-mesh", "2"] + serve + EVAL + TINY,
        "evaluate int8": ["evaluate", "--outdir", "", "--member-mesh", "2"] + serve + EVAL
        + QUANT + TINY,
        "extremes": ["extremes", "--outdir", str(tmp / "extremes"), "--member-mesh", "2"]
        + serve + PAR_EXTREMES + TINY,
        "infer-domain": ["infer-domain", "--outdir", str(tmp / "infer"), "--dp", "2"] + serve
        + infer + TINY,
        "train --dp 2": ["train", "--outdir", str(tmp / "train2"), "--dp", "2"] + train,
        "train --dp -1": ["train", "--outdir", str(tmp / "train-1"), "--dp", "-1"] + train,
        "train --dp 3": ["train", "--outdir", str(tmp / "train3"), "--dp", "3"] + train,
    }


@pytest.fixture(scope="module")
def two_ranks(served, tmp_path_factory):
    """{run name: (rank 0's outcome, rank 1's, its argv)} of _two_rank_argvs."""
    from torch_mp import spawn

    tmp = tmp_path_factory.mktemp("two_ranks")
    argvs = _two_rank_argvs(served[2], tmp)
    torch.save(list(argvs.values()), tmp / "cli.in.pt")
    spawn(["cli"], tmp)
    r0, r1 = (torch.load(tmp / f"cli.rank{r}.pt", weights_only=False) for r in (0, 1))
    return {name: (a, b, argv) for name, a, b, argv in zip(argvs, r0, r1, argvs.values())}


def _one_process(argv, flag):
    """The argv without the parallel flag ``flag`` and its value."""
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


def _assert_json_close(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_json_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (int, float, list)) and not isinstance(want, bool):
        assert_close(got, want, PAR_RTOL, PAR_ATOL, what)
    else:
        assert got == want, what


@pytest.mark.parametrize("cmd", ["evaluate", "extremes"])
@pytest.mark.parametrize("flag", [["--member-mesh", "2"]])
def test_unported_flags_raise(two_ranks, on_cpu, cmd, flag):
    """``--member-mesh 2`` (formerly not ported, raising) on two ranks: the
    members split over ("data" = 1, "member" = 2); rank 0 prints and
    returns the one-process command's JSON (extremes: the annual maxima,
    fits, return levels and plateaus; its bootstrap intervals are refits,
    see the module's docstring); rank 1 returns nothing."""
    got, other, argv = two_ranks[cmd]
    assert other == {"result": None} and flag[0] in argv
    want, _ = tcli.main(_one_process(argv, flag[0]))
    got = got["result"]
    if cmd == "evaluate":
        _assert_json_close(got, want, cmd)
        return
    for name, res in want["pixels"].items():
        for side in ("observed", "model"):
            for k in ("block_maxima", "gev_fit", "return_levels"):
                _assert_json_close(got["pixels"][name][side][k], res[side][k], f"{name}.{k}")
        _assert_json_close(got["pixels"][name]["model"]["empirical_plateau"],
                           res["model"]["empirical_plateau"], name)
    assert got["days"] == want["days"] and got["members"] == want["members"] == 4


def test_member_mesh_int8_evaluate_equals_one_process(two_ranks, on_cpu):
    """``--member-mesh 2 --quant int8``: rank 0 calibrates, broadcasts the
    scales, both ranks serve int8; the JSON of the one-process command."""
    got, other, argv = two_ranks["evaluate int8"]
    assert other == {"result": None}
    want, _ = tcli.main(_one_process(argv, "--member-mesh"))
    _assert_json_close(got["result"], want, "evaluate int8")


def test_infer_domain_dp_raises(two_ranks, on_cpu):
    """``infer-domain --dp 2`` (formerly not ported, raising) on two ranks:
    chunks of 7 tiles round up to 8, each split over the ranks with its
    noise drawn whole; the JSON of the one-process command at chunks of 8."""
    got, other, argv = two_ranks["infer-domain"]
    assert other == {"result": None}
    one = _one_process(argv, "--dp")
    one[one.index("--batch-tiles") + 1] = "8"
    want, _ = tcli.main(one)
    _assert_json_close(got["result"], want, "infer-domain")


# infer-domain on a 38x38 domain (padded to 40 for the 4x pooling: 9 tiles of
# 16 a day, overlap 4), 3 days, chunks of 8 tiles
INFER = ["--domain", "38", "--days", "3", "--members", "3", "--overlap", "4",
         "--batch-tiles", "8"]
QUANT = ["--quant", "int8", "--quant-skip", "heads"]
# int8 against float on the noisy checkpoint: the metrics move by at most
# 15%, the eval-ELBO bound of tests/test_quantize.py (measured: 0.28%
# evaluate, 1.8% extremes' return levels, 0.36% infer-domain)
INT8_RTOL = 0.15
# port-vs-JAX int8 metrics over the JAX loop's int8-vs-float gap
SERVE_SHARE = 0.1
SERVE_ARGS = {"evaluate": EVAL, "extremes": EXTREMES, "infer-domain": INFER}


@pytest.mark.parametrize("cmd", ["evaluate", "extremes", "infer-domain"])
def test_int8_serving_prints_the_jax_scale_counts(served, on_cpu, tmp_path, capsys, cmd):
    """``--quant int8 --quant-skip heads``: the calibration lines of the JAX
    CLI on the same preset, the same counts (the tree's structure does not
    depend on the weights); finite metrics close to the float run's."""
    from probunet_tpu.cli import main as jax_main

    _, _, ckpt = served
    argv = [cmd, "--preset", PRESET] + SERVE_ARGS[cmd] + TINY
    got, spans = tcli.main(argv[:1] + ["--outdir", str(tmp_path / "q"), "--ckpt", ckpt]
                           + argv[1:] + QUANT)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("int8 serve")]
    jax_main(argv[:1] + ["--outdir", str(tmp_path / "jax")] + argv[1:] + QUANT)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("int8 serve")]
    assert lines == want and len(lines) == 2
    assert lines[0] == "int8 serve: --quant-skip ['heads'] pruned 2 of 39 scales"
    assert "calib" in spans
    ref, _ = tcli.main(argv[:1] + ["--outdir", str(tmp_path / "f"), "--ckpt", ckpt] + argv[1:])
    if cmd == "extremes":
        got = {k: got["pixels"][k]["model"]["return_levels"] for k in got["pixels"]}
        ref = {k: ref["pixels"][k]["model"]["return_levels"] for k in ref["pixels"]}
    else:
        got = {k: got[k] for k in ("crps_mean", "mae_mean")}
        ref = {k: ref[k] for k in ("crps_mean", "mae_mean")}
    for key in ref:
        assert np.isfinite(got[key]).all(), key
        assert_close(got[key], ref[key], INT8_RTOL, what=key)
    # the int8 route served: its metrics are not the float run's
    assert any(not np.array_equal(got[key], ref[key]) for key in ref)


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_infer_domain_matches_jax(served, on_cpu, tmp_path, capsys, quant):
    """``infer-domain`` against a loop of the JAX package's functions (its
    dataset, tiles, per-tile statistics, preprocessing, model,
    ``residual_to_hr``, stitch and metrics) fed the port's chunk noise.
    Float: the JSON at the module's tolerances. ``--quant int8
    --quant-skip heads``: the JAX loop serves the tree the JAX package
    calibrates on the same first chunks (the JAX CLI's calibration); the
    port's metrics must lie within SERVE_SHARE of the JAX loop's int8-vs-
    float gap from its int8 metrics (``tests/test_torch_quantize.py``'s
    serving bound; a flipped rounding moves a domain mean little).
    Measured: 0.034 of the gap (CRPS), 0.0025 (MAE)."""
    import jax
    import jax.numpy as jnp

    from probunet_tpu.data.climex import (
        ClimexDataset, Standardization, lrinterp_from_batch, preprocess_batch, residual_to_hr)
    from probunet_tpu.data.transforms import invert_physical_transform
    from probunet_tpu.evals import compute_mae, crps_over_groundtruth
    from probunet_tpu.ops.quantize import calibrate_sample, quant_skip
    from probunet_tpu.parallel.spatial import extract_tiles, stitch_tiles

    jmodel, params, ckpt = served
    out = tmp_path / "id"
    got, spans = tcli.main(["infer-domain", "--preset", PRESET, "--outdir", str(out),
                            "--ckpt", ckpt] + INFER + TINY + (QUANT if quant == "int8" else []))
    assert list(spans) == ["dataset", "init"] + (["calib"] if quant == "int8" else []) + [
        "sample", "metrics", "figures"]
    with open(out / "infer_domain.json") as f:
        assert json.load(f) == got
    assert json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith('{"domain"')][-1]) == got

    cfg = _jax_cfg()
    d = cfg.data
    ds = ClimexDataset(years=range(*d.years_test), variables=d.variables, coords=(0, 38, 0, 38),
                       pipeline=d.pipeline, lowres_scale=4, transfo=d.transfo,
                       interp_mode=d.interp_mode, synthetic=True, pad_to_multiple=True)
    hr = jnp.asarray(ds.get_hr_batch(np.arange(3)))
    tiles, positions = extract_tiles(hr, 16, 4, align=4)
    g = jax.tree.map(jnp.asarray, ds.stats)

    def stat_tiles(arr, scale):
        return jnp.tile(jnp.stack([arr[y // scale:(y + 16) // scale, x // scale:(x + 16) // scale]
                                   for (y, x) in positions]), (3, 1, 1, 1))

    st = Standardization(*(stat_tiles(a, 4 if n.startswith("lr") else 1)
                           for n, a in zip(Standardization._fields, g)))
    p = jax.tree.map(jnp.asarray, params)
    starts = range(0, tiles.shape[0], 8)

    def batch(i):
        sti = jax.tree.map(lambda a: a[i:i + 8], st)
        return sti, preprocess_batch(tiles[i:i + 8], sti, d.pipeline, 4, d.interp_mode,
                                     d.epsilon, d.standardization)

    def decode(mdl, x, eps):
        feats, prior, _ = mdl.encode(x)
        return mdl.decode(feats, prior.mu + prior.sigma * eps)

    def metrics(variables):
        sample = jax.jit(lambda x, eps: jmodel.apply(variables, x, eps, method=decode))
        outs = []
        for c, i in enumerate(starts):
            sti, b = batch(i)
            n = b["inputs"].shape[0]
            eps = tcli.batch_noise(cfg.train.seed, c, 3, n, cfg.model.latent_dim).numpy()
            res = sample(b["inputs"], jnp.asarray(eps))
            outs.append(residual_to_hr(res, lrinterp_from_batch(b, 4, d.interp_mode)[:, None],
                                       jax.tree.map(lambda a: a[:, None], sti), d.pipeline,
                                       d.epsilon, d.standardization))
        full = stitch_tiles(jnp.concatenate(outs), positions, (40, 40))[:, :, :38, :38]
        gt = hr[:, :38, :38]
        if d.transfo:
            full = invert_physical_transform(full, d.variables)
            gt = invert_physical_transform(gt, d.variables)
        return {"crps_mean": crps_over_groundtruth(full, gt)["mean"],
                "mae_mean": compute_mae(full, gt)["mean"]}

    assert got["domain"] == 38 and got["days"] == 3 and got["tiles_per_day"] == 9
    assert got["members"] == 3
    want = metrics({"params": p})
    if quant == "float":
        for key in want:
            assert_close(got[key], want[key], RTOL, ATOL, key)
        return
    scales = calibrate_sample(jmodel, p, [batch(i)[1]["inputs"] for i in starts][:4], 3,
                              key=jax.random.key(cfg.train.seed))
    want_q = metrics({"params": p, "quant": quant_skip(scales, ["heads"])})
    for key in want:
        gap = float(np.abs(np.asarray(want_q[key]) - np.asarray(want[key])).max())
        err = float(np.abs(np.asarray(got[key]) - np.asarray(want_q[key])).max())
        assert gap > 0 and err <= SERVE_SHARE * gap, (key, err, gap)


@pytest.mark.parametrize("pixel", ["16,3", "3,-1"])
def test_pixels_outside_the_grid_raise(on_cpu, tmp_path, pixel):
    with pytest.raises(ValueError, match="outside the 16x16 grid"):
        tcli.main(["extremes", "--preset", PRESET, "--outdir", str(tmp_path),
                   "--pixels", "3,4", pixel] + TINY)


def test_checkpoint_without_best_params_raises(on_cpu, tmp_path):
    for ckpt in (tmp_path, tmp_path / "absent"):
        with pytest.raises(FileNotFoundError, match="best_params.pt"):
            tcli.main(["evaluate", "--preset", PRESET, "--outdir", "",
                       "--ckpt", str(ckpt)] + TINY)
    assert not (tmp_path / "absent").exists()


def test_runs_on_cuda_unless_told(monkeypatch, tmp_path):
    """Without ``PROBUNET_PLATFORM=cpu`` the commands want the card and
    raise without one; an unknown platform raises too."""
    monkeypatch.delenv("PROBUNET_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["pack", "--preset", PRESET, "--out", str(tmp_path / "p.npz")] + TINY)
    monkeypatch.setenv("PROBUNET_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PROBUNET_PLATFORM"):
        tcli.main(["pack", "--preset", PRESET, "--out", str(tmp_path / "p.npz")] + TINY)


def test_figures_are_guarded(served, on_cpu, tmp_path, monkeypatch, capsys):
    """A figure that cannot be drawn is reported; the numbers are still
    written. A failure outside the figures still raises."""
    from probunet_tpu_torch.utils import plotting

    _, _, ckpt = served

    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plotting, "plot_psd", no_matplotlib)
    monkeypatch.setattr(plotting, "plot_return_levels", no_matplotlib)
    got, _ = tcli.main(["evaluate", "--preset", PRESET, "--outdir", str(tmp_path),
                        "--ckpt", ckpt, "--members", "2", "--max-items", "16"] + TINY)
    assert "figures skipped: ImportError" in capsys.readouterr().out
    with open(tmp_path / "eval.json") as f:
        assert json.load(f) == got
    got, _ = tcli.main(["extremes", "--preset", PRESET, "--outdir", str(tmp_path),
                        "--ckpt", ckpt, "--pixels", "3,4", "--days", "64",
                        "--days-per-year", "16", "--n-boot", "5"] + TINY)
    assert "plotting skipped for pixel_3_4: ImportError" in capsys.readouterr().out
    with open(tmp_path / "extremes.json") as f:
        assert json.load(f) == got
    monkeypatch.setattr(EvalAccumulator, "update_hist", no_matplotlib)
    with pytest.raises(ImportError):
        tcli.main(["evaluate", "--preset", PRESET, "--outdir", str(tmp_path),
                   "--members", "2", "--max-items", "16"] + TINY)


def test_module_entry_point(tmp_path):
    """``python -m probunet_tpu_torch`` runs the CLI: on the CPU when asked,
    and without a card and without ``PROBUNET_PLATFORM`` it fails."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "probunet_tpu_torch", "pack", "--preset", PRESET,
           "--split", "test", "--out", str(tmp_path / "p.npz")] + TINY
    env = {k: v for k, v in os.environ.items() if k != "PROBUNET_PLATFORM"}
    env["PYTHONPATH"] = repo
    out = subprocess.run(cmd, env={**env, "PROBUNET_PLATFORM": "cpu"}, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["shape"] == [365, 16, 16, 1]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and "is_available" in out.stderr


TRAIN = ["--set", "train.num_epochs=2", "train.batch_size=64", "train.ensemble_size=4",
         "train.eval_ensemble_size=3"]
DET = ["--preset", "deterministic_64", "--set",
       'data.resolution=[16,16]', 'data.coords=[0,16,0,16]', "data.lowres_scale=4",
       'data.years_train=[1960,1962]', 'data.years_val=[1962,1963]',
       'data.years_test=[1963,1964]', "model.model_channels=8", 'model.channel_mult=[1,2]',
       "model.num_blocks=1", "train.num_epochs=1", "train.batch_size=64"]


def _train(outdir, extra=(), resume=False):
    argv = ["train", "--preset", PRESET, "--outdir", str(outdir)] + TINY + TRAIN[1:] + list(
        extra)
    if resume:
        argv.insert(1, "--resume")
    return tcli.main(argv)


def test_train_then_evaluate_from_its_checkpoint(on_cpu, tmp_path, capsys):
    """``train`` writes config.json, ckpt/ (the full state each epoch and the
    best weights), losses.pkl, the residual-contribution and final lines
    and the loss curves; ``--resume`` continues from the latest step;
    ``evaluate`` serves the best weights."""
    import pickle

    (out, spans) = _train(tmp_path / "run")
    text = capsys.readouterr().out
    lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    assert [next(iter(d)) for d in lines] == ["residual_contribution", "final"]
    assert set(lines[0]["residual_contribution"]) == {"mae_model", "mae_interp", "improvement"}
    assert out["final"] == lines[1]["final"] and out["steps"] == 2 * (365 // 64)
    assert {"dataset", "init", "fit", "contribution", "figures"} <= set(spans)
    with open(tmp_path / "run" / "losses.pkl", "rb") as f:
        hist = pickle.load(f)
    assert {k: v[-1] for k, v in hist.items()} == out["final"]
    assert all(len(v) == 2 for v in hist.values())
    with open(tmp_path / "run" / "config.json") as f:
        assert json.load(f)["train"]["num_epochs"] == 2
    ckpt = tmp_path / "run" / "ckpt"
    assert (ckpt / "best_params.pt").exists() and (tmp_path / "run" / "loss_curves.png").exists()
    (again, _) = _train(tmp_path / "run", ["train.num_epochs=1"], resume=True)
    assert f"resumed from step {out['steps']}" in capsys.readouterr().out
    assert again["steps"] == out["steps"] + 365 // 64
    got, _ = tcli.main(["evaluate", "--preset", PRESET, "--outdir", "", "--ckpt", str(ckpt)]
                       + EVAL + TINY)
    assert got["items"] == 64 and all(np.isfinite(got["crps_mean"]))


def test_pack_feeds_train(on_cpu, tmp_path, capsys):
    """The packed train split trains the model the synthetic split trains,
    to the same losses bit for bit (``pack`` draws the training split's
    synthetic fields; the validation split, drawn from another seed, is the
    synthetic one in both runs)."""
    path = str(tmp_path / "train.npz")
    tcli.main(["pack", "--preset", PRESET, "--split", "train", "--out", path] + TINY)
    direct, _ = _train(tmp_path / "a", ["train.num_epochs=1"])
    packed, _ = _train(tmp_path / "b", ["train.num_epochs=1", f"data.packed_train={path}"])
    assert packed["final"] == direct["final"]


@pytest.mark.parametrize("model,extra", [
    ("unet", []), ("unet", ["model.unet_type=asymmetric_wskips", "model.num_blocks=2",
                            "data.pipeline=lr_to_residuals"]),
    ("linearcnn", []), ("bcsd", [])], ids=["unet", "unet-asymmetric_wskips", "linearcnn",
                                           "bcsd"])
def test_train_det(on_cpu, tmp_path, capsys, model, extra):
    """Each ``--model`` trains (one ``epoch N: mse=`` line) and reports the
    test MAE in physical units; the BCSD MAE equals the JAX CLI's on the same
    synthetic split within rtol 1e-4. Each package applies the storage
    transform to the raw fields itself, which leaves the stored fields an
    ulp apart, and BCSD divides by the training years' interpolated
    precipitation, near 0 at dry pixels, which multiplies those ulps (the
    ratio itself is held to 1e-6 in ``test_torch_baselines.py``)."""
    argv = ["train-det", "--model", model, "--outdir", str(tmp_path)] + DET + extra
    out, spans = tcli.main(argv)
    text = capsys.readouterr().out
    assert json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1]) == out
    if model == "bcsd":
        from probunet_tpu.cli import main as jax_main

        jax_main(argv)
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert want["model"] == "bcsd"
        assert_close(out["test_mae"], want["test_mae"], 1e-4, 0.0, "bcsd test MAE")
        return
    assert "epoch 1: mse=" in text and {"fit", "test_mae"} <= set(spans)
    mae = out["test_mae_real_units"]
    assert list(mae) == ["pr"] and np.isfinite(mae["pr"]) and mae["pr"] > 0


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--dp", "-1"]])
def test_train_flags_not_ported_raise(two_ranks, on_cpu, tmp_path, flag):
    """``train --dp 2`` and ``--dp -1`` (the world size; formerly not
    ported, raising) on two ranks for one epoch: both ranks hold the final
    losses, steps and residual contribution of the one-process command
    (``--dp -1``: of ``--dp 2``'s run, bit for bit); rank 0 wrote the run's
    files."""
    got, other, argv = two_ranks["train " + " ".join(flag)]
    assert other["result"]["final"] == got["result"]["final"]   # replicated
    got = got["result"]
    if flag[1] == "-1":   # the world's size, 2: the run of --dp 2, bit for bit
        assert got == two_ranks["train --dp 2"][0]["result"]
        return
    one = _one_process(argv, "--dp")
    one[one.index("--outdir") + 1] = str(tmp_path / "one")
    want, _ = tcli.main(one)
    assert got["steps"] == want["steps"] == 365 // 64
    for k, v in want["final"].items():
        assert_close(got["final"][k], v, RTOL, ATOL, k)
    for k, v in want["residual_contribution"].items():
        assert_close(got["residual_contribution"][k], v, RTOL, ATOL, k)
    outdir = argv[argv.index("--outdir") + 1]
    assert os.path.exists(os.path.join(outdir, "losses.pkl"))
    assert os.path.exists(os.path.join(outdir, "ckpt", "best_params.pt"))


def test_train_dp_other_than_the_world_raises(two_ranks, on_cpu, tmp_path):
    """``--dp 3`` in a world of 2 raises on every rank, naming the torchrun
    command that starts 3; ``--dp 2`` without torchrun (a world of one)
    likewise, and ``--member-mesh 2`` there too."""
    for outcome in two_ranks["train --dp 3"][:2]:
        assert outcome["raised"] == "ValueError"
        assert "torchrun --nproc-per-node 3" in outcome["message"]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tcli.main(["train", "--preset", PRESET, "--outdir", str(tmp_path), "--dp", "2"] + TINY)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tcli.main(["evaluate", "--preset", PRESET, "--outdir", "", "--member-mesh", "2"] + TINY)


EXPLORE = ["--max-items", "40", "--probe-contexts", "4"]


@pytest.fixture(scope="module")
def trained_ckpt(tmp_path_factory):
    """The checkpoint directory of one epoch of the port's own ``train``."""
    outdir = tmp_path_factory.mktemp("explore_train")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PROBUNET_PLATFORM", "cpu")
        _train(outdir, ["train.num_epochs=1"])
    return str(outdir / "ckpt")


@pytest.mark.parametrize("mode", ["prior", "posterior", "single"])
def test_explore_from_the_trained_checkpoint(trained_ckpt, on_cpu, tmp_path, capsys,
                                            monkeypatch, mode):
    """``explore`` on the weights ``train`` wrote: the default run writes
    the collapse report (printed and in summary.txt), pca_artifacts.pkl,
    the decile and sigma grids (7x7; 10x10 with ``--posterior``) in
    residual and HR space as arrays and figures, and the joint-marginal
    figure; ``--single`` the prior sweep (arrays, four figures and the
    ``{"dims": [...]}`` line). Under ``--posterior`` the figures' inputs are
    recorded instead of drawn."""
    import pickle

    from probunet_tpu_torch.utils import plotting

    flags = {"prior": [], "posterior": ["--posterior"], "single": ["--single"]}[mode]
    drawn = []
    if mode == "posterior":  # the figures' inputs only: drawing 400 panels takes ~10 s
        for name in ("plot_latent_grid", "plot_latent_joint_marginal"):
            monkeypatch.setattr(plotting, name, lambda *a, save_path=None, **k: (
                drawn.append(np.shape(a[0])), open(save_path, "w").close()))
    out, spans = tcli.main(["explore", "--preset", PRESET, "--outdir", str(tmp_path),
                            "--ckpt", trained_ckpt] + flags + EXPLORE + TINY)
    text = capsys.readouterr().out
    files = set(os.listdir(tmp_path))
    assert "[timing]" in text and "figures skipped" not in text
    if mode == "single":
        assert json.loads(text.strip().splitlines()[-2]) == out
        assert len(out["dims"]) == 2 and len(set(out["dims"])) == 2
        assert {"prior_sweep.npz", "prior_sweep.png", "prior_sweep_hr.png",
                "prior_sweep_hr_perpanel.png", "prior_sweep_delta.png"} <= files
        sweep = np.load(tmp_path / "prior_sweep.npz")
        assert sweep["decoded"].shape == sweep["hr"].shape == (6, 6, 16, 16, 1)
        assert np.isfinite(sweep["hr"]).all() and list(sweep["dims"]) == out["dims"]
        return
    with open(tmp_path / "summary.txt") as f:
        summary = f.read()
    assert summary.startswith("latent collapse diagnostics") and summary.strip() in text
    assert "probe contexts             : 4" in summary
    with open(tmp_path / "pca_artifacts.pkl", "rb") as f:
        art = pickle.load(f)
    assert set(art) == {"pca", "latents", "diagnostics"}
    assert art["latents"]["mu"].shape == (40, 4) and out["items"] == 40
    assert art["diagnostics"]["collapsed"] == out["collapsed"]
    n = 10 if mode == "posterior" else 7
    grids = np.load(tmp_path / "grids.npz")
    for name in ("decile", "sigma", "decile_hr", "sigma_hr"):
        assert grids[name].shape == (n, n, 16, 16, 1) and np.isfinite(grids[name]).all()
        assert f"grid_{name}.png" in files
    assert "latent_joint_marginal.png" in files
    if mode == "posterior":  # the joint-marginal scores, then the four grids
        assert drawn == [(40, 4)] + [(10, 10, 16, 16, 1)] * 4
    assert {"dataset", "init", "latents", "diagnostics", "grids", "figures"} <= set(spans)


def test_explore_figures_are_guarded(trained_ckpt, on_cpu, tmp_path, monkeypatch, capsys):
    from probunet_tpu_torch.utils import plotting

    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(plotting, "plot_latent_grid", no_matplotlib)
    out, _ = tcli.main(["explore", "--preset", PRESET, "--outdir", str(tmp_path), "--single",
                        "--ckpt", trained_ckpt] + TINY)
    assert "figures skipped: ImportError" in capsys.readouterr().out
    assert (tmp_path / "prior_sweep.npz").exists() and len(out["dims"]) == 2
