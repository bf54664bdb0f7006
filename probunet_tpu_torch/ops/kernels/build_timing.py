"""Time the kernel library's build two ways on one machine.

    python3 -m probunet_tpu_torch.ops.kernels.build_timing

``parallel`` is ``_build.build()``: one nvcc process per source, all
started together, then a link. ``serial`` is one nvcc call that compiles
every source in turn and links them. The two run in the order serial,
parallel, parallel, serial, each from nothing built, and each time is
printed with the machine's CPU count.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from probunet_tpu_torch.ops.kernels import _build


def serial_seconds() -> float:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    try:
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                        "-shared", "-o", str(workdir / "lib.so"),
                        *map(str, sorted(_build.CSRC_DIR.glob("*.cu")))],
                       check=True, capture_output=True)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def parallel_seconds() -> float:
    _build.library_path().unlink(missing_ok=True)
    info = _build.build()
    if not info["built"]:
        raise AssertionError("the library was not rebuilt")
    return info["seconds"]


def main() -> None:
    times = {"serial": [], "parallel": []}
    for kind in ("serial", "parallel", "parallel", "serial"):
        s = serial_seconds() if kind == "serial" else parallel_seconds()
        times[kind].append(s)
        print(f"build {kind}: {s:.2f} s")
    print(f"cpus={os.cpu_count()} sources={len(list(_build.CSRC_DIR.glob('*.cu')))} "
          + " ".join(f"{k}_mean={sum(v) / len(v):.2f}" for k, v in times.items()))


if __name__ == "__main__":
    main()
