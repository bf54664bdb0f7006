"""The comparison comes out not correct with the timed path broken
underneath (a tiny run on the CPU, the program's code patched where the
fault would sit), and for the control of each mode's limits."""

from __future__ import annotations

import json

import torch

from conftest import run_tiny

SHIFT = 0.1   # physical units (mm/day, K): a tenth of a degree


def test_state_left_unchanged(tiny, monkeypatch):
    from probunet_tpu_torch.train import state

    monkeypatch.setattr(state.AdamW, "step", lambda self, grads: True)
    _, _, line = run_tiny(*tiny, "train")
    assert not line["correct"] and line["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out(tiny, monkeypatch):
    from probunet_tpu_torch.train import loop

    make = loop.make_elbo_loss_fn

    def halved(*args, **kwargs):
        fn = make(*args, **kwargs)

        def loss_fn(hr, stats, gen, b0, b1, eps=None, seeds=None, *rest):
            h = hr.shape[0] // 2
            return fn(hr[:h], stats, gen, b0, b1, None if eps is None else eps[:, :h], seeds,
                      *rest)
        return loss_fn

    monkeypatch.setattr(loop, "make_elbo_loss_fn", halved)
    _, _, line = run_tiny(*tiny, "train")
    assert not line["correct"]


def test_half_of_a_batch_not_scored(tiny, monkeypatch):
    from probunet_tpu_torch.evals import streaming

    update = streaming.EvalAccumulator.update
    monkeypatch.setattr(streaming.EvalAccumulator, "update",
                        lambda self, ens, gt: update(self, ens[: len(ens) // 2],
                                                     gt[: len(gt) // 2]))
    _, _, line = run_tiny(*tiny, "evaluate")
    assert not line["correct"]


def test_an_answer_altered(tiny, monkeypatch):
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    sample = ProbabilisticUNet.sample

    def altered(self, *args, **kwargs):
        out = sample(self, *args, **kwargs).clone()
        out[0, 0] += 0.05
        return out

    monkeypatch.setattr(ProbabilisticUNet, "sample", altered)
    _, _, line = run_tiny(*tiny, "evaluate")
    assert not line["correct"]


def test_control_train_fp8_reference(tiny):
    """The control of the training cells' limits: the reference with fp8
    operands in the program's place reads past the limits."""
    from benchmark import compare, harness
    from benchmark.reference.model import ProbUNet

    root, spec = tiny
    cell = harness.load_cell("tiny_train", root, spec)
    mode = harness.load_module(harness.HERE / "modes" / "train.py", "t_mode_train")
    dev = torch.device("cpu")
    raw, idx, noise = mode.check_inputs(cell, 11, dev,
                                        len(ProbUNet(harness.sizes(cell)).dropout_blocks))
    ref = compare.reference_train(cell, 11, raw, idx, noise, dev)
    low = compare.reference_train(cell, 11, raw, idx, noise, dev, cast=compare.fp8)
    checks = compare._checks(compare.train_numbers(low, ref), cell.limits)
    assert any(v > lim for _, v, lim in checks)


def test_control_evaluate_fp8_reference(tiny):
    """The control of the evaluation cells' limits: the reference with fp8
    operands in the program's place reads past the limits."""
    from benchmark import compare, harness
    from probunet_tpu_torch.data.loader import Batches

    root, spec = tiny
    cell = harness.load_cell("tiny_evaluate", root, spec)
    mode = harness.load_module(harness.HERE / "modes" / "evaluate.py", "t_mode_evaluate")
    dev = torch.device("cpu")
    raw = mode.split(cell, 12, dev)
    order = list(Batches(raw.shape[0], cell.params["batch_size"]))
    batches = [(i, order[i]) for i in mode.checked(12, len(order), 2)]
    ref = compare.reference_eval(cell, 12, raw, batches, dev)
    low = compare.reference_eval(cell, 12, raw, batches, dev, cast=compare.fp8)
    checks = compare._checks(compare.eval_numbers(low, ref), cell.limits)
    assert any(v > lim for _, v, lim in checks)


def test_members_shifted_by_one_constant(tiny, monkeypatch):
    """Every member shifted by the same constant (a wrong mean added on the
    way back to physical fields) leaves the spread as it was, and comes
    out not correct at the flagship evaluation cell's own limits."""
    from benchmark import harness
    from probunet_tpu_torch.evals import streaming

    root, spec = tiny
    flagship = harness.load_cell("multivar128_evaluate16")
    path = root / "workloads" / "tiny_evaluate.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), limits=flagship.limits)))
    update = streaming.EvalAccumulator.update
    monkeypatch.setattr(streaming.EvalAccumulator, "update",
                        lambda self, ens, gt: update(self, ens + SHIFT, gt))
    _, out, line = run_tiny(root, spec, "evaluate")
    assert not line["correct"], line["checks"]
    ref, got = out.facts["readings"]["reference"], out.facts["readings"]["program"]
    spread_gap = max(float(abs(g["spread"] - r["spread"]).max() / abs(r["spread"]).max())
                     for g, r in zip(got, ref))
    assert spread_gap < 1e-4
