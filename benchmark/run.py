"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload multivar128_train --seed 7 --seconds 20 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell
asks for (``BENCHMARK.json``). The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks``: each number
compared beside its limit); the last lines of standard error repeat the
checks. Without a card, or where a module of JAX or of the JAX package
was loaded, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache of the run at a fixed path in the checkout
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
