"""Time kernels C, C′, D and G of two checkouts of the repo on one card.

    python3 -m probunet_tpu_torch.ops.kernels.ab_timing DIR_A DIR_B

The checkouts run in the order A, B, B, A, each in a process of its own
that builds (or loads) that checkout's kernel library and imports that
checkout's ``chip_smoke.py``. Each run times C and C′ at
``chip_smoke.GN_CASES[0]`` (the flagship's (128, 128, 128, 32) bf16
chain, FiLM and dropout 0.1), D at (128, 128, 128, 32) bf16, p = 0.1, and
G at ``chip_smoke.G_CASES[0]`` (the batch's (128, 128, 128, 3) f32 pooled
by 16) through ``chip_smoke._gn_vs_plain``, ``_dropout_vs_plain`` and
``_avg_pool_vs_plain``, which also hold each kernel against its plain
version. Prints one JSON line a run, and the card's name and power limit
first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from probunet_tpu_torch.ops.kernels import _build

_build.build()
_build.library()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(1234)

def randn(*shape, scale=1.0):
    return scale * torch.randn(shape, generator=gen, device=dev)

rows = cs._gn_vs_plain(randn, dev, *cs.GN_CASES[0])
d = cs._dropout_vs_plain(randn, (cs.BATCH, 128, 128, 32), "bfloat16", 0.1)
g = cs._avg_pool_vs_plain(gen, dev, *cs.G_CASES[0], cs._card())
print("AB " + json.dumps({"C_ms": rows["fused_gn"]["ms"], "C'_ms": rows["fused_gn_bwd"]["ms"],
                          "D_ms": d["ms"], "G_ms": g["ms"]}))
"""


def main(argv: list[str] | None = None) -> None:
    dirs = argv if argv is not None else sys.argv[1:]
    if len(dirs) != 2:
        raise SystemExit("usage: python3 -m probunet_tpu_torch.ops.kernels.ab_timing DIR_A DIR_B")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    for label, d in zip("ABBA", (dirs[0], dirs[1], dirs[1], dirs[0])):
        d = os.path.abspath(d)
        env = {**os.environ, "PYTHONPATH": d}
        out = subprocess.run([sys.executable, "-c", _CHILD], cwd=d, env=env,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"ab_timing: run {label} in {d} failed ({out.returncode})")
        line = next(x for x in out.stdout.splitlines() if x.startswith("AB "))
        print(json.dumps({"run": label, "dir": d, **json.loads(line[3:])}), flush=True)


if __name__ == "__main__":
    main()
