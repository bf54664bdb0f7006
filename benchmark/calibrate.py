"""Readings for the limits of a cell's correctness numbers, in one process.

    python3 benchmark/calibrate.py --workload multivar128_train \\
        --seeds 11,12,13 --control-seeds 21,22,23 [--seconds 2]

For each of ``--seeds``: a run of the cell as the benchmark runs it (the
window ``--seconds`` long; a training cell's readings need none), its
numbers printed (the lower readings: a sound program's). For each of
``--control-seeds``: the control, the reference with fp8 operands in the
program's place (the nearest precision below the configuration's bf16),
and for a training cell the planted faults "half of the batch left out,
the mean taken over the rest" (the reference on half of each batch
against the whole) and "a step that returns its state unchanged". Each
reading goes through the harness's comparison at the cell's committed
limits (``compare._checks`` with the workload file's ``limits``): one JSON
line a reading, with every number, the checks (value, limit) and
``correct``; then a summary line: per number the largest program reading
and the smallest control and fault readings.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def numbers(cell, outcome) -> dict:
    """Every number of a run's comparison, held to a limit or not."""
    from benchmark import compare

    r = outcome.facts["readings"]
    if cell.mode == "train":
        return compare.train_numbers(r["program"], r["reference"])
    return compare.eval_numbers(r["program"], r["reference"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--dump", default="", help="a directory for every reading's raw values")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import compare, harness

    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = harness.load_cell(args.workload)
    readings: dict[str, dict[str, list]] = {"program": {}, "control": {}, "half_batch": {},
                                            "unchanged": {}}

    def dump(kind, seed, got, want):
        if args.dump:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            torch.save({"got": got, "want": want}, Path(args.dump) / f"{kind}_{seed}.pt")

    def note(kind, seed, numbers, failed=0):
        checks = compare._checks(numbers, cell.limits)
        correct = all(v <= lim for _, v, lim in checks) and failed == 0
        print(json.dumps({"kind": kind, "seed": seed, **numbers,
                          "checks": {n: [v, lim] for n, v, lim in checks},
                          "correct": correct}), flush=True)
        for k, v in numbers.items():
            readings[kind].setdefault(k, []).append(v)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run, out = harness.execute(cell, seed, args.seconds, False, dev)
        note("program", seed, numbers(cell, out), out.failed)
        dump("program", seed, out.facts["readings"]["program"], out.facts["readings"]["reference"])
        del run, out
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        if cell.mode == "train":
            mode = harness.load_module(harness.HERE / "modes" / "train.py", "bench_mode_train")
            from benchmark.reference.model import ProbUNet

            blocks = len(ProbUNet(harness.sizes(cell)).dropout_blocks)
            raw, idx, noise = mode.check_inputs(cell, seed, dev, blocks)
            ref = compare.reference_train(cell, seed, raw, idx, noise, dev)
            low = compare.reference_train(cell, seed, raw, idx, noise, dev, cast=compare.fp8)
            note("control", seed, compare.train_numbers(low, ref))
            dump("control", seed, low, ref)
            half = compare.reference_train(cell, seed, raw, idx, noise, dev,
                                           items=cell.params["batch_size"] // 2)
            note("half_batch", seed, compare.train_numbers(half, ref))
            dump("half_batch", seed, half, ref)
            same = compare.reference_train(cell, seed, raw, idx, noise, dev, update=False)
            note("unchanged", seed, compare.train_numbers(same, ref))
        else:
            mode = harness.load_module(harness.HERE / "modes" / "evaluate.py",
                                       "bench_mode_evaluate")
            from probunet_tpu_torch.data.loader import Batches

            tp = cell.params
            raw = mode.split(cell, seed, dev)
            order = list(Batches(raw.shape[0], tp["batch_size"]))
            picked = mode.checked(seed, len(order), tp["checked_batches"])
            batches = [(i, order[i]) for i in picked]
            ref = compare.reference_eval(cell, seed, raw, batches, dev)
            low = compare.reference_eval(cell, seed, raw, batches, dev, cast=compare.fp8)
            note("control", seed, compare.eval_numbers(low, ref))
            dump("control", seed, low, ref)
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
    names = sorted(set().union(*(r.keys() for r in readings.values())))
    summary = {k: {"program_max": max(readings["program"].get(k, [float("nan")])),
                   "control_min": min(readings["control"].get(k, [float("nan")])),
                   "half_batch_min": min(readings["half_batch"].get(k, [float("nan")])),
                   "unchanged_min": min(readings["unchanged"].get(k, [float("nan")]))}
               for k in names}
    print(json.dumps({"summary": summary, "workload": cell.name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
