"""Build the CUDA sources of ``probunet_tpu_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one process per
source, all started together — and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads. The library is
built at first use into ``probunet_tpu_torch/_build/`` (listed in
``.gitignore``) and named after a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing here
runs at import time: the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry -> argument types; every entry returns an int (cudaError_t)
_SIGNATURES = {
    "afcrps_tile_pixels": (),
    "afcrps_terms_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _P),
    "afcrps_terms_bwd": (_P,) * 6 + (_I, _I, _I, _LL, _LL, _LL, _LL, _I, _P),
    "dropout_apply": (_P, _P, _P, _LL, _I, _F, _F, _I, _P),
    "fcomb_crps_partials": (_I, _I, _I, _I, _I, _I, _P),
    "fcomb_crps_terms_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P),
    "fcomb_crps_terms_bwd": (_P,) * 15 + (_I, _I, _I, _I, _I, _P),
    "fused_gn_tiles": (_I, _I),
    "fused_gn_fwd": (_P,) * 10 + (_I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    "fused_gn_bwd": (_P,) * 15 + (_I, _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I, _P),
    "fused_gn_cluster_occupancy": (_I, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels can only be built where the CUDA toolkit is")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libprobunet_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless the current one exists; returns
    ``{"path", "built", "seconds", "log"}`` (``log``: nvcc's output,
    including ptxas' register and shared-memory report)."""
    path = library_path()
    if path.exists():
        return {"path": str(path), "built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    workdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    log = []
    try:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = workdir / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, proc in procs:  # wait for every compile, so none outlives the build
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = workdir / "lib.so"
        link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(link.stdout)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"path": str(path), "built": True,
            "seconds": time.perf_counter() - t0, "log": "".join(log)}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with argtypes and
    restype declared for every C entry."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.probunet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.probunet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        text = library().probunet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
